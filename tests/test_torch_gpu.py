"""Card-only tests of the PyTorch/CUDA port: the hand-written CUDA kernels
(edit distance; the merge sweep's partition and segment walks) against
their plain PyTorch versions (and the host Myers scan), and the combine
and call_sample device paths on the card against their host paths. They
skip where no CUDA card is visible. This file imports neither JAX nor
the JAX package, so on the card it runs without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import clustering as tc
from sniffles_tpu_torch.ops import edit_distance_batch as ted
from sniffles_tpu_torch.ops.edit_distance import edit_distance

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def seeded_pairs(n, max_len, seed):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    pairs = [("".join(rng.choice(bases, int(rng.integers(0, max_len)))),
              "".join(rng.choice(bases, int(rng.integers(0, max_len)))))
             for _ in range(n)]
    top = max_len - 1
    return pairs + [("", ""), ("A" * top, ""), ("", "C" * top),
                    ("A" * top, "A" * top), ("A" * top, "T" * top)]


def case_pairs(kind, max_len, seed):
    """Byte-string pairs: random DNA, lengths at the 32-bit word
    boundaries of the bit-vector scan, or alphabets beyond ACGT (DNA
    with N, more than 8 distinct bytes, and arbitrary bytes)."""
    if kind == "random":
        return [(x.encode(), y.encode()) for x, y in seeded_pairs(64, max_len, seed)]
    rng = np.random.default_rng(seed)

    def rand(alphabet, n):
        return bytes(rng.choice(list(alphabet), n).tolist())

    def related(a, alphabet, n):
        t = bytearray(a[:n]) + rand(alphabet, max(0, n - len(a)))
        for _ in range(4):
            if t:
                t[int(rng.integers(0, len(t)))] = int(rng.choice(list(alphabet)))
        return bytes(t)

    if kind == "word_bounds":
        lens = (0, 1, 31, 32, 33, 63, 64, 65, 1023, 1024, 4095)
        out = []
        for x in lens:
            for y in lens:
                a = rand(b"ACGT", x)
                out.append((a, related(a, b"ACGT", y)))
        return out
    # 5 symbols (DNA with N), more than 8 (lowercase, N, IUPAC), any bytes
    iupac = b"ACGTNacgtnRYKMSWBDHV"
    out = [(rand(b"ACGT", 900), rand(b"ACGTN", 880))]
    for x, y in ((1000, 990), (33, 64), (64, 33), (1, 200), (0, 5), (4095, 4000)):
        x, y = min(x, max_len - 1), min(y, max_len - 1)
        a = rand(b"ACGTN", x)
        out.append((a, related(a, b"ACGTN", y)))
        a = rand(iupac, x)
        out += [(a, related(a, iupac, y)), (a, rand(b"ACGT", y)),
                (rand(bytes(range(256)), x), rand(bytes(range(256)), y))]
    return out


def encode_bytes(pairs, L):
    B = len(pairs)
    a = np.zeros((B, L), dtype=np.uint8)
    b = np.zeros((B, L), dtype=np.uint8)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x, dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y, dtype=np.uint8)
    la = np.array([len(x) for x, _ in pairs], dtype=np.int32)
    lb = np.array([len(y) for _, y in pairs], dtype=np.int32)
    return a, b, la, lb


@pytest.mark.parametrize("max_len,seed,kind", [
    pytest.param(128, 11, "random", id="128-11"),
    pytest.param(1024, 12, "random", id="1024-12"),
    pytest.param(4096, 13, "random", id="4096-13"),
    pytest.param(4096, 14, "word_bounds", id="word_bounds"),
    pytest.param(4096, 15, "alphabets", id="alphabets"),
])
def test_cuda_kernel_matches_plain_version(card, max_len, seed, kind):
    pairs = case_pairs(kind, max_len, seed)
    tensors = [torch.from_numpy(x).to(card) for x in encode_bytes(pairs, max_len)]
    launches = ted.COUNTS["launches"]
    out = ted.edit_distance_batch_device(*tensors)
    torch.cuda.synchronize()
    assert ted.COUNTS["launches"] == launches + 1
    assert torch.equal(out, ted.edit_distance_batch_plain(*tensors))
    host = np.array([edit_distance(x.decode("latin-1"), y.decode("latin-1"))
                     for x, y in pairs], dtype=np.int32)
    assert (out.cpu().numpy() == host).all()


def test_cuda_kernel_rejects_out_of_range_lengths(card):
    a, b, la, lb = (torch.from_numpy(x).to(card)
                    for x in ted.encode_pairs([("ACGT", "AC")], 128))
    with pytest.raises(ValueError):
        ted.edit_distance_batch_device(a, b, la + 200, lb)


def test_combine_on_cuda_matches_host(card, monkeypatch, tmp_path):
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.sim import write_cohort

    snfs = write_cohort(str(tmp_path / "cohort"), 6, 41,
                        contigs=(("chr1", 300_000),), lengths=(60, 300, 800))

    def records(path):
        with open(path) as f:
            return [line for line in f if not line.startswith("##")]

    host = tmp_path / "host.vcf"
    assert cli.main(["--input", *snfs, "--vcf", str(host), "--no-tpu"]) == 0
    monkeypatch.setattr(ted, "DEVICE_MIN_CELLS", 1)
    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU", raising=False)
    ted.reset_counts()
    dev = tmp_path / "dev.vcf"
    assert cli.main(["--input", *snfs, "--vcf", str(dev), "--threads", "0"]) == 0
    assert ted.COUNTS["launches"] >= 1
    assert records(dev) == records(host)


SWEEP = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
             cluster_merge_bnd=1000, global_repeat=False)
CUTS = {k: SWEEP[k] for k in ("cluster_r", "cluster_repeat_h_max", "cluster_merge_bnd")}


@pytest.mark.parametrize("seed,size,svtypes", [
    pytest.param(1, 32768, (0, 1, 2, 3, 4), id="32768"),
    pytest.param(2, 2048, (0, 1, 2, 3, 4), id="2048"),
    pytest.param(3, 2048, (4,), id="bnd-chains"),
    pytest.param(4, 512, (1,), id="del-chain"),
    pytest.param("head-alone", 2048, None, id="layout-head-alone"),
    pytest.param("bnd-chains", 2048, None, id="layout-bnd-chains"),
    pytest.param("cascade", 2048, None, id="layout-cascade"),
])
def test_merge_sweep_kernel_matches_plain_version(card, seed, size, svtypes):
    """Both kernels against their plain versions: the state arrays bit for
    bit and the counts (iterations, depth, segments, passes, collapse) of
    the sweep, and the cut flags of sweep_cuts; the sweep launches each
    kernel once. The cascade layout takes the fixpoint's collapse."""
    from sniffles_tpu_torch.sim import fuzz_call_batch, sweep_layout_batches
    batch = (sweep_layout_batches()[seed] if svtypes is None
             else fuzz_call_batch(seed, size, svtypes=svtypes))
    packed = torch.from_numpy(batch).to(card)
    inputs, state = tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(packed), 100), 100)
    host_inputs = {k: v.cpu() for k, v in inputs.items()}
    cut, _, cut_counts = tc.launch_sweep_cuts(inputs, state, packed.shape[1], **CUTS)
    plain_cut, _, plain_cut_counts = tc.sweep_cuts_plain(
        host_inputs, {k: v.cpu() for k, v in state.items()}, **CUTS)
    nseeds = int(host_inputs["nseeds"][0])     # the kernel writes the live flags only
    assert torch.equal(cut.cpu()[:nseeds], plain_cut[:nseeds])
    assert torch.equal(cut_counts.cpu(), plain_cut_counts)
    kernel = {k: v.clone() for k, v in state.items()}
    launches = dict(tc.COUNTS)
    counts = tc.merge_sweep(inputs, kernel, **SWEEP)
    torch.cuda.synchronize()
    assert tc.COUNTS == {k: v + 1 for k, v in launches.items()}
    plain = {k: v.cpu().clone() for k, v in state.items()}
    assert torch.equal(counts.cpu(), tc.merge_sweep_plain(host_inputs, plain, **SWEEP))
    for k in tc.SWEEP_STATE:
        got = kernel[k].cpu()
        if got.dtype == torch.float32:
            got, plain[k] = got.view(torch.int32), plain[k].view(torch.int32)
        assert torch.equal(got, plain[k]), k
    assert int(kernel["alive"].sum()) < int(inputs["nseeds"][0])
    assert bool(counts[4]) == (seed == "cascade")


def test_call_sample_on_cuda_matches_host(card, monkeypatch, tmp_path):
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset

    svs = [PlantedSV(pos=p, svtype=k, svlen=ln) for p, k, ln in
           ((30_000, "DEL", 120), (60_000, "INS", 150), (90_000, "DUP", 900),
            (120_000, "INV", 700), (150_000, "DEL", 2000))]
    bam, fa = write_dataset(str(tmp_path), ref_len=200_000, depth=24, read_len=12_000,
                            seed=11, svs=svs)

    def records(path):
        with open(path) as f:
            return [line for line in f if not line.startswith("#")]

    args = ["--input", bam, "--reference", fa, "--threads", "0"]
    host = tmp_path / "host.vcf"
    assert cli.main([*args, "--vcf", str(host), "--no-tpu"]) == 0
    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU", raising=False)
    tc.reset_counts()
    dev = tmp_path / "dev.vcf"
    assert cli.main([*args, "--vcf", str(dev)]) == 0
    assert tc.COUNTS == {"launches": 1, "sweep_cuts": 1}
    assert len(records(host)) == len(svs)
    assert records(dev) == records(host)
