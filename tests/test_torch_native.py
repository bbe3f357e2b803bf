"""The port's native host library (sniffles_tpu_torch/csrc/host/, built
here by the host C++ compiler into build/torch_kernels/) against the JAX
package's (native/libbamcore.so through sniffles_tpu.io.native) on the
same inputs, made from seeds: the BGZF inflate, the record scan, the
split-chain scan, the coverage adder, the INS consensus and the graph
POA. Within the port: its native leads equal its pure-Python leads, the
native INS consensus equals the numpy one, and the native split filter
keeps the pure-Python boundary where a fused multiply-add would move it.

Both packages' libraries are loaded in this process: each is opened with
RTLD_LOCAL, so their symbols of one name never meet."""
import dataclasses
import os
import random
import shutil
from fractions import Fraction

import numpy as np
import pytest

from sniffles_tpu.io import native as jax_native
from sniffles_tpu.io.bam import AlignmentFile as JaxAlignmentFile
from sniffles_tpu_torch.config import SnifflesConfig
from sniffles_tpu_torch.io import native
from sniffles_tpu_torch.io.bam import AlignmentFile
from sniffles_tpu_torch.io.bamwrite import BamRecordSpec, write_bam
from sniffles_tpu_torch.leads import LeadProvider
from sniffles_tpu_torch.ops import _build
from sniffles_tpu_torch.region import Region
from sniffles_tpu_torch.sim import PlantedSV, random_seq, write_dataset


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native host library is built at first use")
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built (make -C native)")


@pytest.fixture(scope="module")
def split_bam(tmp_path_factory):
    """A BAM whose reads carry every lead kind: CIGAR INS/DEL, split reads
    of DUP and INV (SA tags), two contigs."""
    svs = [PlantedSV(pos=p, svtype=t, svlen=ln, vaf=v)
           for p, t, ln, v in [(20_000, "DUP", 900, 1.0), (45_000, "INV", 700, 1.0),
                               (70_000, "DEL", 400, 0.5), (95_000, "INS", 250, 1.0),
                               (120_000, "DUP", 1500, 1.0), (150_000, "INV", 2500, 1.0)]]
    bam, _ = write_dataset(str(tmp_path_factory.mktemp("native")), ref_len=180_000, svs=svs,
                           depth=16, read_len=12_000, seed=5, n_contigs=2)
    return bam


def test_library_is_the_ports_own_build():
    path = _build.host_library_path()
    assert native.get_lib()._name == path
    assert path.startswith(_build.BUILD_DIR) and os.path.exists(path)
    assert "native" not in os.path.relpath(path, _build.BUILD_DIR)
    assert os.path.realpath(path) != os.path.realpath(jax_native.get_lib()._name)


def test_bgzf_inflate_matches_jax(split_bam):
    """The whole BAM inflated by each library, and a reused-buffer inflate
    of a block range, equal byte for byte (and equal to zlib's)."""
    import gzip
    with open(split_bam, "rb") as f:
        raw = f.read()
    ours = native.bgzf_inflate(raw)
    assert ours == jax_native.bgzf_inflate(raw) == gzip.decompress(raw)
    blocks = list(native.walk_blocks(raw))
    assert blocks == list(jax_native.walk_blocks(raw))
    lo, hi = blocks[2][0], blocks[9][0]
    isize = sum(b[2] for b in blocks[2:9])
    a = native.bgzf_inflate_into(raw, lo, hi, isize, reuse=True)
    b = jax_native.bgzf_inflate_into(raw, lo, hi, isize, reuse=True)
    assert a.tobytes() == b.tobytes() and len(a) == isize


@pytest.mark.parametrize("min_event_len", [20, 45])
def test_scan_records_and_splits_match_jax(split_bam, min_event_len):
    """Every chunk of both contigs: the record columns, the CIGAR events,
    the region mask and the split-chain scan of the SA carriers equal the
    JAX package's library's."""
    ours, theirs = AlignmentFile(split_bam, require_index=True), JaxAlignmentFile(
        split_bam, require_index=True)
    n_records = n_events = n_hints = 0
    for contig in ours.references:
        end = ours.get_reference_length(contig)
        for (res, mask), (jres, jmask) in zip(
                ours.scan_region(contig, 0, end, min_event_len),
                theirs.scan_region(contig, 0, end, min_event_len), strict=True):
            assert res.n == jres.n and res.n_events == jres.n_events
            for k in res.cols:
                assert np.array_equal(res.cols[k], jres.cols[k]), k
            for k in res.events:
                assert np.array_equal(res.events[k], jres.events[k]), k
            assert np.array_equal(mask, jmask)
            assert res.buf.tobytes() == jres.buf.tobytes()
            sa = np.nonzero(res.cols["sa_off"] >= 0)[0]
            want = np.where((res.cols["flag"][sa] & 0x800) != 0, 1, 3).astype(np.uint8)
            kw = dict(minsvlen=35, long_ins_half=1250.0, seq_cap=50_000, max_splits_base=3,
                      max_splits_kb=0.1, mapq_min=20, keep_lowqual=False)
            got = native.scan_splits(res.buf, res.cols["offset"][sa], res.cols["rec_len"][sa],
                                     want, contig, **kw)
            expect = jax_native.scan_splits(jres.buf, jres.cols["offset"][sa],
                                            jres.cols["rec_len"][sa], want, contig, **kw)
            for g, e in zip(got, expect, strict=True):
                assert g.keys() == e.keys()
                for k in g:
                    assert np.array_equal(g[k], e[k]), k
            n_records += res.n
            n_events += res.n_events
            n_hints += len(got[1]["h_read"])
    assert n_records > 400 and n_events > 50 and n_hints > 20


def test_coverage_add_matches_jax_and_numpy():
    rng = np.random.default_rng(8)
    for n, length in ((0, 100), (1, 10), (500, 20_000), (3000, 5_000)):
        starts = rng.integers(-50, length + 50, n).astype(np.int64)
        ends = starts + rng.integers(0, 3000, n).astype(np.int64)
        base = rng.integers(0, 60_000, length).astype(np.uint16)
        lo, hi = 7, length - 3
        ours, theirs = base.copy(), base.copy()
        native.coverage_add(starts, ends, ours, lo, hi)
        jax_native.coverage_add(starts, ends, theirs, lo, hi)
        diff = np.zeros(hi - lo + 1, dtype=np.int64)
        np.add.at(diff, np.clip(starts - lo, 0, hi - lo), 1)
        np.add.at(diff, np.clip(ends - lo, 0, hi - lo), -1)
        plain = base.copy()
        plain[lo:hi] += np.cumsum(diff[:-1]).astype(np.uint16)
        assert np.array_equal(ours, theirs) and np.array_equal(ours, plain)
    with pytest.raises(ValueError):
        native.coverage_add(starts.astype(np.int32), ends, ours, 0, 10)


def _noisy(rng, seq, rate):
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice("ACGT"))
        elif r < rate:
            out.append(ch + rng.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out)


@dataclasses.dataclass
class _Lead:
    seq: str


@pytest.mark.parametrize("seed", range(4))
def test_consensus_novel_matches_jax_and_numpy(seed):
    """bamcore_consensus_novel of both libraries, and the port's numpy
    path (novel_from_reads with debug set), on noisy copies of one
    insertion."""
    from sniffles_tpu_torch.consensus import novel_from_reads
    rng = random.Random(seed)
    truth = "".join(rng.choice("ACGT") for _ in range(rng.randint(60, 900)))
    best = _noisy(rng, truth, 0.03)
    others = [_noisy(rng, truth, 0.08) for _ in range(rng.randint(0, 12))]
    for klen, skip, skip_rep in ((6, 3, 3), (8, 4, 2), (4, 1, 1)):
        ours = native.consensus_novel(best.encode(), [s.encode() for s in others],
                                      klen, skip, skip_rep)
        theirs = jax_native.consensus_novel(best.encode(), [s.encode() for s in others],
                                            klen, skip, skip_rep)
        plain = novel_from_reads(_Lead(best), [_Lead(s) for s in others], klen, skip,
                                 skip_rep, debug=True)
        assert ours == theirs == plain, (klen, skip, skip_rep)
        assert novel_from_reads(_Lead(best), [_Lead(s) for s in others], klen, skip,
                                skip_rep) == ours
    assert native.consensus_novel(best.encode(), [], 9, 3, 3) is None


@pytest.mark.parametrize("seed,length,rate,min_cov", [
    (1, 300, 0.05, 1), (2, 1500, 0.08, 3), (3, 4000, 0.10, 5), (4, 50, 0.2, 2)])
def test_poa_consensus_matches_jax(seed, length, rate, min_cov):
    rng = random.Random(seed)
    truth = "".join(rng.choice("ACGT") for _ in range(length))
    reads = [_noisy(rng, truth, rate) for _ in range(rng.randint(3, 15))]
    for slack in (64, 256):
        ours = native.poa_consensus(reads, min_coverage=min_cov, band_slack=slack)
        assert ours == jax_native.poa_consensus(reads, min_coverage=min_cov,
                                                band_slack=slack)
        assert ours
    from sniffles_tpu.ops.poa import poa as jax_poa
    from sniffles_tpu_torch.ops.poa import poa
    assert poa(reads[:9], min_coverage=min_cov) == jax_poa(reads[:9], min_coverage=min_cov)


def _lead_key(ld):
    d = dataclasses.asdict(ld)
    d.pop("read_id")  # ids depend on the iteration counter only
    bnd = d.pop("bnd_info")
    if bnd:
        d["bnd"] = tuple(sorted(bnd.items()))
    d.pop("svtypes_starts_lens")
    return tuple(sorted((k, v) for k, v in d.items()))


def _scan_both(bam_path, contig, *flags):
    """The port's native and pure-Python leads of one contig, with their
    coverage tracks and regional NM statistics."""
    out = []
    for scan in ("_iter_region_native", "_iter_region_python"):
        config = SnifflesConfig("--input", bam_path, "--vcf", "x.vcf", *flags)
        bam = AlignmentFile(bam_path, require_index=True)
        region = Region(contig, 0, bam.get_reference_length(contig))
        provider = LeadProvider(config, 0, contig)
        provider.coverage = np.zeros(region.end, dtype=np.uint16)
        leads = list(getattr(provider, scan)(bam, region))
        out.append((leads, provider.coverage, provider.average_regional_nm))
    return out


def _assert_scans_equal(native_scan, python_scan):
    (n_leads, n_cov, n_nm), (p_leads, p_cov, p_nm) = native_scan, python_scan
    assert [_lead_key(a) for a in n_leads] == [_lead_key(b) for b in p_leads]
    assert np.array_equal(n_cov, p_cov)
    assert n_nm == p_nm


@pytest.mark.parametrize("flags", [(), ("--qc-nm",), ("--phase", "--minsvlen", "40")],
                         ids=["default", "qc-nm", "phase"])
def test_native_leads_match_python(split_bam, flags):
    """The port's native scan against its pure-Python scan, lead for lead,
    coverage and NM statistic, on both contigs; the dataset exercises the
    split classifier."""
    for contig in ("chr1", "chr2"):
        native_scan, python_scan = _scan_both(split_bam, contig, *flags)
        _assert_scans_equal(native_scan, python_scan)
        sources = {ld.source for ld in python_scan[0]}
        assert "INLINE" in sources and sources & {"SPLIT_PRIM", "SPLIT_SUP"}, sources
        assert {"DUP", "INV", "INS", "DEL"} <= {ld.svtype for ld in python_scan[0]}


def _fma_boundaries():
    """(max_splits_base, max_splits_kb, read length, SA count) where Python's
    split bound, base + kb * (qlen / 1000.0) with two roundings, equals
    the SA count while the same sum with one rounding (a fused
    multiply-add) lies below it; found by exact rational arithmetic."""
    found = []
    for base in (-2, -3, -4):
        for kb in (0.3, 0.7):
            for qlen in (10_000, 20_000):
                two = base + kb * (qlen / 1000.0)
                one = float(Fraction(base) + Fraction(kb) * Fraction(qlen / 1000.0))
                if one < two == int(two) > 0:
                    found.append((base, kb, qlen, int(two)))
    return found


def _split_read_bam(path, qlen, n_sa):
    """Reads of length qlen, each cut into n_sa + 1 forward segments 10 kb
    apart on the reference: the primary alignment and n_sa SA entries."""
    rng = np.random.default_rng(qlen + n_sa)
    seg = qlen // (n_sa + 1)
    records = []
    for r in range(6):
        seq = random_seq(rng, qlen)
        start = 5_000 + 40 * r
        parts = [(start + 10_000 * i, i * seg, seg if i < n_sa else qlen - i * seg)
                 for i in range(n_sa + 1)]

        def cigar(q0, ln):
            ops = [("S", q0)] if q0 else []
            return ops + [("M", ln)] + ([("S", qlen - q0 - ln)] if qlen - q0 - ln else [])

        sa = "".join(f"chr1,{p + 1},+,{''.join(f'{n}{o}' for o, n in cigar(q0, ln))},60,0;"
                     for p, q0, ln in parts[1:])
        records.append(BamRecordSpec(qname=f"r{r}", flag=0, refid=0, pos=parts[0][0],
                                     mapq=60, cigar=cigar(0, parts[0][2]), seq=seq,
                                     tags={"NM": 0, "SA": sa}))
    write_bam(path, [("chr1", 200_000)], records,
              sam_header="@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:200000\n")
    return path


@pytest.mark.parametrize("base,kb,qlen,n_sa", [(3, 0.1, 10_000, 4), (3, 0.1, 10_000, 5),
                                               *_fma_boundaries()])
def test_split_filter_boundary(tmp_path, base, kb, qlen, n_sa):
    """At the split bound of bamcore.cc (:1688-1690), n_sa > base + kb *
    (qlen / 1000.0): the native scan keeps or drops each read as the
    pure-Python scan does. The defaults (3, 0.1) put the bound at 4.0 for
    10 kb reads: 4 SA entries are kept, 5 dropped. The other cases are the
    ones where a fused multiply-add, which -march=native lets GCC emit
    unless -ffp-contract=off, would put the bound just below the count
    and drop the read."""
    bam = _split_read_bam(str(tmp_path / "splits.bam"), qlen, n_sa)
    native_scan, python_scan = _scan_both(bam, "chr1", "--max-splits-base", str(base),
                                          "--max-splits-kb", str(kb))
    _assert_scans_equal(native_scan, python_scan)
    kept = base + kb * (qlen / 1000.0) >= n_sa
    split_leads = [ld for ld in python_scan[0] if ld.source.startswith("SPLIT")]
    assert bool(split_leads) == kept, (len(split_leads), kept)


def test_fma_boundaries_exist():
    """The search above finds the boundaries the filter test needs."""
    assert len(_fma_boundaries()) >= 3


def test_jax_native_split_filter_drops_reads_at_fma_boundary(tmp_path):
    """Found in the JAX package and not inherited: native/Makefile builds
    libbamcore.so with -O3 -march=native and no -ffp-contract=off, and its
    split bound is fused on a CPU with FMA. At (base -2, kb 0.3) a 10 kb
    read with one SA entry is kept by the pure-Python scan and dropped by
    that library; the port's library keeps it (test_split_filter_boundary)."""
    from sniffles_tpu.config import SnifflesConfig as JaxConfig
    from sniffles_tpu.leads import LeadProvider as JaxLeadProvider
    from sniffles_tpu.region import Region as JaxRegion
    bam = _split_read_bam(str(tmp_path / "splits.bam"), 10_000, 1)
    counts = []
    for scan in ("_iter_region_native", "_iter_region_python"):
        config = JaxConfig("--input", bam, "--vcf", "x.vcf", "--max-splits-base", "-2",
                           "--max-splits-kb", "0.3")
        provider = JaxLeadProvider(config, 0, "chr1")
        provider.coverage = np.zeros(200_000, dtype=np.uint16)
        leads = getattr(provider, scan)(JaxAlignmentFile(bam, require_index=True),
                                        JaxRegion("chr1", 0, 200_000))
        counts.append(sum(1 for ld in leads if ld.source.startswith("SPLIT")))
    assert counts == [0, 6], counts
