"""The port's .vcf.gz output (io/tabix.py: bgzip + a .tbi index, and the
TabixFile reader) against the JAX package's.

At function level, tabix_compress_and_index of the two packages, given
the same uncompressed VCF, writes the same .gz and .tbi bytes, and
TabixFile.fetch of every contig gives back the file's records in order.
At the CLI, a .vcf.gz of call_sample and of combine holds the plain
VCF's records (genotype_vcf: tests/test_torch_genotype_e2e.py), as the
JAX package's does; a combine of more inputs than
--combine-max-inmemory-results with .gz output takes the tmp-file path,
where both packages write an unsorted plain VCF instead."""
import os
import shutil

import numpy as np
import pytest

from sniffles_tpu.io import tabix as jax_tabix
from sniffles_tpu_torch.io import tabix
from sniffles_tpu_torch.io.bgzf import decompress_all
from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from tests.test_torch_combine_e2e import write_port_cohort
from tests.test_torch_snf_e2e import run, split_vcf


def synthetic_vcf(path, seed, contigs=(("chr1", 2500), ("chr2", 40), ("chrX", 1800))):
    """A sorted VCF of several BGZF blocks: per contig, records at rising
    positions with REF alleles of 1 to 20,000 bases, so that records
    span tabix bins of every level."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2\n"] + [f"##contig=<ID={c},length=300000000>\n"
                                          for c, _ in contigs]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    records = {}
    for contig, n in contigs:
        pos = 1
        for k in range(n):
            pos += int(rng.integers(1, 120_000))
            ref = "N" * int(rng.choice((1, 50, 3_000, 20_000)))
            line = f"{contig}\t{pos}\tid{k}\t{ref}\t<DEL>\t60\tPASS\tSVTYPE=DEL\n"
            lines.append(line)
            records.setdefault(contig, []).append(line.rstrip("\n"))
    with open(path, "w") as f:
        f.writelines(lines)
    return records


@pytest.mark.parametrize("seed", [1, 2])
def test_gz_and_tbi_bytes_equal_the_jax_packages(seed, tmp_path):
    records = synthetic_vcf(tmp_path / "in.vcf", seed)
    for name in ("port", "jax"):
        shutil.copy(tmp_path / "in.vcf", tmp_path / f"{name}.vcf")
    tabix.tabix_compress_and_index(str(tmp_path / "port.vcf"), str(tmp_path / "port.vcf.gz"))
    jax_tabix.tabix_compress_and_index(str(tmp_path / "jax.vcf"), str(tmp_path / "jax.vcf.gz"))
    assert not (tmp_path / "port.vcf").exists()
    for suffix in (".vcf.gz", ".vcf.gz.tbi"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes(), suffix
    assert decompress_all(str(tmp_path / "port.vcf.gz")) == (tmp_path / "in.vcf").read_bytes()

    reader = tabix.TabixFile(str(tmp_path / "port.vcf.gz"))
    assert reader.contigs == list(records)
    for contig, lines in records.items():
        assert list(reader.fetch(contig, 0, 2 ** 29)) == lines, contig
        # a window: the records that overlap it, in order
        lo, hi = 5_000_000, 9_000_000
        want = [line for line in lines
                if int(line.split("\t")[1]) - 1 < hi
                and int(line.split("\t")[1]) - 1 + len(line.split("\t")[3]) > lo]
        assert list(reader.fetch(contig, lo, hi)) == want, contig
    assert list(reader.fetch("chr7", 0, 100)) == []
    # the JAX package's reader runs on past the contig's last record
    jax_reader = jax_tabix.TabixFile(str(tmp_path / "jax.vcf.gz"))
    assert list(jax_reader.fetch("chr1", 0, 2 ** 29))[len(records["chr1"])].startswith("chr2")


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tabixbam")
    return write_dataset(str(tmp), ref_len=150_000, depth=18, read_len=10_000, seed=71,
                         n_contigs=2, svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                                           PlantedSV(pos=90_000, svtype="INS", svlen=200)])


def fetch_all(path):
    reader = tabix.TabixFile(str(path))
    return [line + "\n" for contig in reader.contigs
            for line in reader.fetch(contig, 0, 2 ** 29)]


def test_call_sample_vcf_gz_holds_the_plain_records(small_bam, tmp_path):
    bam, fasta = small_bam
    args = ["--input", bam, "--reference", fasta, "--threads", "0"]
    run("sniffles_tpu_torch", [*args, "--vcf", str(tmp_path / "plain.vcf")], tmp_path)
    run("sniffles_tpu_torch", [*args, "--vcf", str(tmp_path / "port.vcf.gz")], tmp_path)
    run("sniffles_tpu.cli", [*args, "--tpu-call", "--vcf", str(tmp_path / "jax.vcf.gz")],
        tmp_path)
    plain = split_vcf(tmp_path / "plain.vcf")
    assert len(plain[1]) == 4
    assert split_vcf(tmp_path / "port.vcf.gz") == plain
    assert split_vcf(tmp_path / "jax.vcf.gz") == plain
    assert fetch_all(tmp_path / "port.vcf.gz") == plain[1]
    assert not (tmp_path / "port.vcf").exists()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return write_port_cohort(tmp_path_factory.mktemp("tabixcohort"))


def test_combine_vcf_gz_holds_the_plain_records(cohort, tmp_path):
    args = ["--input", *cohort, "--threads", "0"]
    run("sniffles_tpu_torch", [*args, "--vcf", str(tmp_path / "plain.vcf")], tmp_path)
    run("sniffles_tpu_torch", [*args, "--vcf", str(tmp_path / "port.vcf.gz")], tmp_path)
    run("sniffles_tpu.cli", [*args, "--tpu-combine", "--vcf", str(tmp_path / "jax.vcf.gz")],
        tmp_path)
    plain = split_vcf(tmp_path / "plain.vcf")
    assert len(plain[1]) >= 8
    assert split_vcf(tmp_path / "port.vcf.gz") == plain
    assert split_vcf(tmp_path / "jax.vcf.gz") == plain
    assert fetch_all(tmp_path / "port.vcf.gz") == plain[1]


def test_combine_past_the_in_memory_results_with_gz_output(cohort, tmp_path):
    """More inputs than --combine-max-inmemory-results: the tmp-file
    results, and with .gz output both packages switch sorting off and
    write the plain VCF under the uncompressed name."""
    outs = {}
    for label, module, extra in (("port", "sniffles_tpu_torch", []),
                                 ("jax", "sniffles_tpu.cli", ["--tpu-combine"])):
        d = tmp_path / label
        d.mkdir()
        run(module, ["--input", *cohort, "--threads", "0", "--combine-max-inmemory-results",
                     "2", "--vcf", "m.vcf.gz", *extra], d)
        assert [f for f in sorted(os.listdir(d)) if f.startswith("m.")] == ["m.vcf"], label
        outs[label] = split_vcf(d / "m.vcf")
    run("sniffles_tpu_torch", ["--input", *cohort, "--threads", "0", "--vcf",
                               str(tmp_path / "sorted.vcf")], tmp_path)
    assert outs["port"] == outs["jax"]
    assert sorted(outs["port"][1]) == sorted(split_vcf(tmp_path / "sorted.vcf")[1])


def test_gz_output_is_sorted_with_no_sort(small_bam, tmp_path):
    """--no-sort does not apply to .gz output (config.sort), in both
    packages: the index needs sorted records."""
    bam, fasta = small_bam
    args = ["--input", bam, "--reference", fasta, "--threads", "0", "--no-sort"]
    run("sniffles_tpu_torch", [*args, "--vcf", str(tmp_path / "port.vcf.gz")], tmp_path)
    run("sniffles_tpu.cli", [*args, "--vcf", str(tmp_path / "jax.vcf.gz"), "--tpu-call"],
        tmp_path)
    records = split_vcf(tmp_path / "port.vcf.gz")[1]
    assert records == split_vcf(tmp_path / "jax.vcf.gz")[1] == fetch_all(tmp_path /
                                                                          "port.vcf.gz")
    assert len(records) == 4
