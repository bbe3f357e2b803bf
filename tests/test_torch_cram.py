"""The port's CRAM codecs, writer and reader (sniffles_tpu_torch/io/
cram_codecs.py, cram31.py, cramwrite.py, cram.py) against the JAX
package's on the same inputs, made from seeds.

Codecs: every stream encodes to the same bytes in both packages and each
package decodes the other's; rANS 4x8 runs in each package's native
library, and the port's pure-Python version (rans_*_plain) writes and
reads the same streams. Files: a CRAM written by the port equals the JAX
package's for the same BAM and FASTA byte for byte (the .crai compared
decompressed, its gzip member stamps the time); the port reads back the
BAM's records, by contig and region through the .crai, and refuses a
reference-based CRAM without its reference."""
import gzip
import os
import random
import shutil

import numpy as np
import pytest

from sniffles_tpu.io import cram31 as jax31
from sniffles_tpu.io import native as jax_native
from sniffles_tpu.io import cram_codecs as jaxc
from sniffles_tpu.io.cram import CramFile as JaxCramFile
from sniffles_tpu.io.cramwrite import bam_to_cram as jax_bam_to_cram
from sniffles_tpu_torch.io import cram31, cram_codecs, native
from sniffles_tpu_torch.io.bam import AlignmentFile
from sniffles_tpu_torch.io.bamwrite import BamRecordSpec, write_bam
from sniffles_tpu_torch.io.cram import CramFile
from sniffles_tpu_torch.io.cramwrite import bam_to_cram
from sniffles_tpu_torch.sim import PlantedSV, write_cram, write_dataset
from tests.test_bam_fuzz import random_cigar


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native host library is built at first use")


def corpus():
    rng = random.Random(42)
    return {
        "empty": b"", "one": b"A", "tiny": b"ACGT", "three": b"ACG",
        "quals": bytes(rng.choice(b"\x16\x19\x1b\x28") for _ in range(5000)),
        "seq": bytes(rng.choice(b"ACGTN") for _ in range(4096)),
        "runs": b"".join(bytes([rng.randrange(4)]) * rng.randrange(1, 40) for _ in range(300)),
        "text": b"read1.2827 maps to chr20:5000-6000 MAPQ 60 " * 64,
        "random": bytes(rng.randrange(256) for _ in range(3000)),
        "skew": bytes(rng.choices(range(256), weights=[1000] + [1] * 255, k=4000)),
        "allsame": b"\x00" * 2048, "ff": b"\xff" * 999,
        "edge255": bytes(range(250, 256)) * 100,
    }


def test_itf8_ltf8_cross():
    rng = random.Random(1)
    itf8 = [0, 1, 127, 128, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000, 0xFFFFFFF, 0x10000000,
            2 ** 31 - 1, -1, -13, -2 ** 31] + [rng.randrange(-2 ** 31, 2 ** 31)
                                                for _ in range(300)]
    for v in itf8:
        enc = cram_codecs.itf8_encode(v)
        assert enc == jaxc.itf8_encode(v)
        assert jaxc.itf8_decode(enc, 0) == cram_codecs.itf8_decode(enc, 0) == (v, len(enc))
    ltf8 = [0, 127, 128, 0x3FFF, 0x200000, 2 ** 28, 2 ** 34, 2 ** 41, 2 ** 48, 2 ** 55,
            2 ** 63 - 1, -1, -2 ** 63] + [rng.randrange(-2 ** 63, 2 ** 63) for _ in range(300)]
    for v in ltf8:
        enc = cram_codecs.ltf8_encode(v)
        assert enc == jaxc.ltf8_encode(v)
        assert jaxc.ltf8_decode(enc, 0) == cram_codecs.ltf8_decode(enc, 0) == (v, len(enc))
    # the native tokenizer of a whole stream, a truncated tail left unparsed
    stream = b"".join(cram_codecs.itf8_encode(v) for v in itf8)
    assert native.itf8_bulk(stream) == jax_native.itf8_bulk(stream)
    vals, ends = native.itf8_bulk(stream + b"\xff")
    assert vals == itf8 and ends[-1] == len(stream)


@pytest.mark.parametrize("order", [0, 1])
def test_rans_4x8_cross(order):
    """Native and plain encoders give the JAX package's bytes; every
    decoder reads every encoder's stream."""
    for name, data in corpus().items():
        enc = cram_codecs.rans_encode(data, order)
        assert enc == jaxc.rans_encode(data, order), name
        assert cram_codecs.rans_encode_plain(data, order) == enc, name
        assert cram_codecs.rans_decode(enc) == data, name
        assert cram_codecs.rans_decode_plain(enc) == data, name
        assert jaxc.rans_decode(enc) == data, name
    with pytest.raises(ValueError, match="order"):
        cram_codecs.rans_decode(b"\x05" + bytes(8))


@pytest.mark.parametrize("flags", [0, 0x01, 0x04, 0x08, 0x40, 0x80, 0x41, 0xC1, 0x20])
def test_rans_nx16_cross(flags):
    for name, data in corpus().items():
        enc = cram31.rans_nx16_encode(data, flags)
        assert enc == jax31.rans_nx16_encode(data, flags), name
        assert cram31.rans_nx16_decode(enc) == jax31.rans_nx16_decode(enc) == data, name


@pytest.mark.parametrize("flags", [0, 0x01, 0x08, 0x20, 0x40, 0x80, 0x41, 0xC1])
def test_arith_cross(flags):
    for name, data in corpus().items():
        enc = cram31.arith_encode(data, flags)
        assert enc == jax31.arith_encode(data, flags), name
        assert cram31.arith_decode(enc) == jax31.arith_decode(enc) == data, name


@pytest.mark.parametrize("sep", [b"\n", b"\x00"])
def test_tok3_cross(sep):
    rng = random.Random(5)
    names = [f"m{rng.randint(1, 9)}_{i // 7}/{rng.randint(0, 99999)}/ccs".encode()
             for i in range(400)] + [b"read.1", b"read.1", b"x", b"", b"r9:12:0003"]
    blob = sep.join(names)
    enc = cram31.tok3_encode(blob)
    assert enc == jax31.tok3_encode(blob)
    assert cram31.tok3_decode(enc) == jax31.tok3_decode(enc)
    assert jax31.tok3_decode(enc).split(sep)[:len(names)] == names


def test_fqzcomp_cross():
    rng = random.Random(6)
    lengths = [rng.randint(0, 300) for _ in range(60)]
    quals = bytearray()
    for ln in lengths:
        q = 30
        for _ in range(ln):
            q = min(60, max(2, q + rng.randint(-3, 3)))
            quals.append(q)
    quals = bytes(quals)
    enc = cram31.fqzcomp_encode(quals, lengths)
    assert enc == jax31.fqzcomp_encode(quals, lengths)
    assert cram31.fqzcomp_decode(enc) == jax31.fqzcomp_decode(enc) == quals
    assert cram31.fqzcomp_decode(enc, return_lengths=True) == \
        jax31.fqzcomp_decode(enc, return_lengths=True)


def norm_cigar(ct):
    out = []
    for op, ln in ct:
        op = 0 if op in (7, 8) else op   # =/X -> M (CRAM normalization)
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


def fuzz_bam(path, seed, n=80):
    """Random records (clips, INS/DEL, =/X, SA, HP/PS, float and array
    tags) on one contig, written by the port's BAM writer."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    records, pos = [], 1000
    for i in range(n):
        cigar, qlen = random_cigar(rng)
        if rng.random() < 0.2:
            cigar = [("H", rng.randint(1, 50))] + cigar
        if rng.random() < 0.2:
            cigar = cigar + [("H", rng.randint(1, 50))]
        tags = {"NM": rng.randint(0, 50)}
        if rng.random() < 0.4:
            tags["SA"] = "chr1,500,+,100M,60,2;"
        if rng.random() < 0.3:
            tags["HP"] = rng.randint(1, 2)
            tags["PS"] = rng.randint(1, 10 ** 6)
        if rng.random() < 0.2:
            tags["XF"] = rng.random()
        if rng.random() < 0.2:
            tags["XB"] = [rng.randint(-5, 5) for _ in range(rng.randint(0, 4))]
        records.append(BamRecordSpec(
            qname=f"fz{i:04d}", flag=rng.choice([0, 16, 0x800 | 16]), refid=0, pos=pos,
            mapq=rng.randint(0, 60), cigar=cigar,
            seq="".join(nprng.choice(list("ACGT"), size=qlen)), tags=tags))
        pos += rng.randint(100, 2000)
    write_bam(path, [("chr1", 2_000_000)], records,
              sam_header="@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:2000000\n")
    return path


def record_key(read):
    return (read.query_name, read.flag, read.reference_id, read.reference_start,
            read.mapping_quality, norm_cigar(read.cigartuples), read.query_sequence,
            read.reference_length, read.query_alignment_start, read.query_alignment_length,
            sorted((k, round(v, 6) if isinstance(v, float) else v)
                   for k, v in read.tags.items()))


@pytest.fixture(scope="module")
def sim_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("cramsim")
    return write_dataset(str(d), ref_len=90_000, depth=8, seed=5, n_contigs=2,
                         svs=[PlantedSV(svtype="DEL", pos=30_000, svlen=120),
                              PlantedSV(svtype="INS", pos=60_000, svlen=90)])


@pytest.mark.parametrize("version", [(3, 0), (3, 1)], ids=["3.0", "3.1"])
@pytest.mark.parametrize("kind", ["reference-based", "embedded", "referenceless", "fuzz"])
def test_cramwrite_equals_jax(tmp_path, sim_pair, version, kind):
    """The port's bam_to_cram writes the JAX package's bytes; its .crai
    holds the same entries."""
    if kind == "fuzz":
        bam, fasta = fuzz_bam(str(tmp_path / "fuzz.bam"), seed=version[1]), None
    else:
        bam, fasta = sim_pair
    kwargs = dict(reference_filename=fasta if kind != "referenceless" else None,
                  records_per_slice=23, embed_reference=kind == "embedded", version=version)
    # one file name in two directories: the file definition holds the name
    (tmp_path / "ours").mkdir()
    (tmp_path / "theirs").mkdir()
    ours, theirs = str(tmp_path / "ours" / "s.cram"), str(tmp_path / "theirs" / "s.cram")
    bam_to_cram(bam, ours, **kwargs)
    jax_bam_to_cram(bam, theirs, **kwargs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with gzip.open(ours + ".crai") as a, gzip.open(theirs + ".crai") as b:
        assert a.read() == b.read()
    # each package reads the other's file into the same records
    reference = fasta if kind == "reference-based" else None
    got = [record_key(r) for r in CramFile(theirs, reference_filename=reference).fetch()]
    expect = [record_key(r) for r in JaxCramFile(ours, reference_filename=reference).fetch()]
    assert got == expect and len(got) > 20


@pytest.mark.parametrize("seed", [0, 1])
def test_cram_records_equal_bam(tmp_path, seed):
    bam = fuzz_bam(str(tmp_path / "fuzz.bam"), seed)
    cram = str(tmp_path / "fuzz.cram")
    bam_to_cram(bam, cram, records_per_slice=17)
    reader = AlignmentFile(cram, mode="rc", require_index=True)
    assert isinstance(reader, CramFile)
    breads, creads = list(AlignmentFile(bam).fetch()), list(reader.fetch())
    assert [record_key(r) for r in creads] == [record_key(r) for r in breads]
    assert len(breads) == 80


def test_sim_cram_reads_equal_bam_per_contig_and_region(sim_pair):
    """sim.write_cram's reference-based CRAM: each contig's reads and 15
    random regions fetched through the .crai equal the BAM's; the index
    statistics and header agree."""
    bam_path, fasta = sim_pair
    cram_path = write_cram(bam_path, fasta, bam_path[:-4] + ".region.cram")
    bam = AlignmentFile(bam_path, require_index=True)
    cram = AlignmentFile(cram_path, require_index=True, reference_filename=fasta)
    assert cram.references == bam.references and cram.lengths == bam.lengths
    assert [s.total for s in cram.get_index_statistics()] == \
        [s.total for s in bam.get_index_statistics()]
    assert cram.mapped == bam.mapped
    assert cram.get_tid("chr2") == bam.get_tid("chr2") == 1
    for contig in bam.references:
        assert [record_key(r) for r in cram.fetch(contig)] == \
            [record_key(r) for r in bam.fetch(contig)]
    rng = random.Random(7)
    for _ in range(15):
        contig = rng.choice(bam.references)
        start = rng.randint(0, 85_000)
        end = start + rng.randint(200, 30_000)
        assert [r.query_name for r in cram.fetch(contig, start, end)] == \
            [r.query_name for r in bam.fetch(contig, start, end)], (contig, start, end)
    assert os.path.getsize(cram_path) < os.path.getsize(bam_path)


def test_reference_required_guard(tmp_path, sim_pair):
    """A reference-based CRAM read without its reference fails loudly, as
    in the JAX package, instead of decoding bases as N."""
    bam, fasta = sim_pair
    cram_path = str(tmp_path / "rr.cram")
    bam_to_cram(bam, cram_path, reference_filename=fasta)
    with pytest.raises(ValueError, match="reference"):
        list(CramFile(cram_path, require_index=True).fetch())
    with pytest.raises(ValueError, match="reference"):
        list(JaxCramFile(cram_path, require_index=True).fetch())
