"""The port's population SNF (--dev-population-snf writes it from a
combine, --combine-population annotates a combine with it) against the
JAX package's, on the cases of the JAX package's own tests
(tests/test_modes_e2e.py::test_population_snf_and_annotation and the
inline multi-contig regression test_population_annotation_multi_contig,
where the shared config's population handle must be opened once).

The population SNFs of the port and of the JAX package, on the device
and host paths at --threads 0 and 2, are equal in the sense of
tests/test_torch_snf_e2e.py (index, decompressed blocks, config apart
from the named keys), and so are the combined VCFs' records; each
package reads the other's population SNF to the same POPULATION_AF and
POPULATION_SIZE. Each run is its own subprocess with a directory of its
own and the same relative file names."""
import shutil

import pytest

from sniffles_tpu_torch.sim import PlantedSV, write_dataset
from tests.test_torch_snf_e2e import assert_snfs_equal, run, split_vcf

COMBINE_RUNS = {
    "port-device": ("sniffles_tpu_torch", ["--threads", "0"]),
    "port-host": ("sniffles_tpu_torch", ["--threads", "0", "--no-tpu"]),
    "port-threads-2": ("sniffles_tpu_torch", ["--threads", "2"]),
    "jax-device": ("sniffles_tpu.cli", ["--threads", "0", "--tpu-combine"]),
    "jax-host": ("sniffles_tpu.cli", ["--threads", "0"]),
    "jax-threads-2": ("sniffles_tpu.cli", ["--threads", "2", "--tpu-combine"]),
}

CASES = {
    # test_population_snf_and_annotation
    "one-contig": dict(ref_len=150_000, depth=24, read_len=10_000, seed=8,
                       svs=[PlantedSV(pos=60_000, svtype="DEL", svlen=180)]),
    # test_population_annotation_multi_contig
    "multi-contig": dict(ref_len=150_000, depth=24, read_len=10_000, seed=40,
                         svs=[PlantedSV(pos=60_000, svtype="DEL", svlen=180)],
                         n_contigs=2, contig_len=1_000_000),
}


def sample_snfs(tmp, spec):
    """Two SNFs of one BAM, sample ids A and B, written by the port."""
    bam, _ = write_dataset(str(tmp), **spec)
    snfs = []
    for name in ("s1", "s2"):
        snf = tmp / f"{name}.snf"
        run("sniffles_tpu_torch", ["--input", bam, "--snf", str(snf), "--sample-id",
                                   "A" if name == "s1" else "B", "--threads", "0"], tmp)
        snfs.append(snf)
    return snfs


def combine(label, module, args, snfs, root, extra_files=()):
    """One combine run in root/label, holding copies of the SNFs."""
    d = root / label
    d.mkdir()
    for path in (*snfs, *extra_files):
        shutil.copy(path, d)
    run(module, ["--input", "s1.snf", "s2.snf", *args], d)
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_population_snf_matches_jax(case, tmp_path):
    snfs = sample_snfs(tmp_path, CASES[case])
    n_records = 1 if case == "one-contig" else 2
    written = {}
    for label, (module, extra) in COMBINE_RUNS.items():
        written[label] = combine(label, module, ["--vcf", "multi.vcf",
                                                 "--dev-population-snf", "pop.snf", *extra],
                                 snfs, tmp_path)
    reference = written["jax-device"]
    records = split_vcf(reference / "multi.vcf")[1]
    assert len(records) == n_records
    for label, d in written.items():
        blocks = assert_snfs_equal(d / "pop.snf", reference / "pop.snf")
        assert split_vcf(d / "multi.vcf")[1] == records, label
    assert sum(len(spans) for spans in blocks.values()) == n_records

    # each package annotates a fresh combine with its own and the other's
    # population SNF
    annotated = {}
    for combiner, (module, extra) in (("port", COMBINE_RUNS["port-device"]),
                                      ("port-host", COMBINE_RUNS["port-host"]),
                                      ("jax", COMBINE_RUNS["jax-device"])):
        for writer in ("port-device", "jax-device"):
            d = combine(f"annotate-{combiner}-with-{writer}", module,
                        ["--vcf", "m2.vcf", "--combine-population", "pop.snf", *extra],
                        snfs, tmp_path, [written[writer] / "pop.snf"])
            annotated[(combiner, writer)] = split_vcf(d / "m2.vcf")[1]
    reference = annotated[("jax", "jax-device")]
    assert len(reference) == n_records
    for line in reference:
        assert "POPULATION_AF=1.000" in line and "POPULATION_SIZE=2" in line, line
    for key, lines in annotated.items():
        assert lines == reference, key
