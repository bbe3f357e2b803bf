"""Card-only tests of the PyTorch/CUDA port: the hand-written CUDA kernels
(edit distance; the merge sweep's partition, its candidate cuts in shared
memory and in global scratch, and segment walks; the fused
engine's relaxation, one cooperative launch, on every engine input and
on 2^16 slots of tiled 36-link chains, with its grid and time stamps; its
candidate tail at odd widths under three flag sets and with its cluster
ids in a view off the 16-byte boundary, and the tail's run pass alone on
sim.tail_run_layouts at 2^21 ids and the engine's ids, in a view at each
16-byte offset; the call statistics'
keys, run pass and thread, warp and block tiers on seeded, edge, tier
and huge batches, under other tier thresholds, on the run pass's edge
layouts, on the engine's 2^16 batch, and on the call task, the call
path's mesh step and the engine;
the clustering's segmented sorts and gather on every sim.seg_sort_batch
population, under other tier thresholds, with no host synchronisation,
and on every caller) against their plain
PyTorch versions (and the host Myers scan), and the combine and
call_sample device paths on the card against their host paths, the
native host library beside a CUDA context, the cluster_assign step, the
combine greedy's grid and flush kernels and the engine's step, whole and
sharded, on the card against the CPU, the engine step's spans (host
ranges alone, each launch inside the step, 111 launches), and its
replays as one CUDA graph against its eager body (bit for bit, after a
refill, beside held outputs, launch counts, a capture that raises). They
skip where no CUDA card is visible. This file imports neither JAX nor
the JAX package, so on the card it runs without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import functools

import numpy as np
import pytest
import torch

from sniffles_tpu_torch.ops import clustering as tc
from sniffles_tpu_torch.ops import edit_distance_batch as ted
from sniffles_tpu_torch.ops.edit_distance import edit_distance
from sniffles_tpu_torch.sim import tail_run_layouts

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
# the default configuration's call step parameters (standard_call_meta)
META = dict(SWEEP, cluster_merge_len=0.22, minsvlen=50, cluster_merge_pos=150, binsize=100,
            resplit_binsize=20)


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


def candidate_cuts(inputs, state):
    """The initial cuts of a task (its live seeds' svtype changes and gaps
    beyond both caps): the candidates sweep_cuts stages."""
    live = int(inputs["nseeds"][0])
    st, sb, eb = (inputs["seed_type"].cpu(), inputs["start_bp"].cpu(), state["end_bp"].cpu())
    j = torch.arange(live)
    prev = (j - 1).clamp(min=0)
    gap = (sb[:live] - eb[prev]).to(torch.float32)
    limit = max(CUTS["cluster_merge_bnd"], CUTS["cluster_repeat_h_max"])
    return int(((j == 0) | (st[:live] != st[prev]) | (gap > limit)).sum())


def held_cuts(inputs, state, n, **kw):
    """sweep_cuts' cut flags (the live ones), heads and counts == the plain
    partition's."""
    cut, heads, counts = tc.launch_sweep_cuts(inputs, state, n, **CUTS, **kw)
    plain_cut, plain_heads, plain_counts = tc.sweep_cuts_plain(
        {k: v.cpu() for k, v in inputs.items()}, {k: v.cpu() for k, v in state.items()}, **CUTS)
    live, segments = int(inputs["nseeds"][0]), int(plain_counts[2])
    assert torch.equal(cut.cpu()[:live], plain_cut[:live])
    assert heads.cpu()[:segments].tolist() == plain_heads.tolist()
    assert torch.equal(counts.cpu(), plain_counts)
    return plain_counts


@pytest.mark.parametrize("case", ["fuzz 32768", "chain", "cascade", "bnd-chains"])
def test_sweep_cuts_on_both_sides_of_the_shared_memory_threshold(card, case):
    """A task's candidates in shared memory (the default, and a threshold
    of exactly its candidates) and in the global scratch (one candidate
    fewer, and none): the same flags, heads and counts as the plain
    partition; the cascade layout takes the fixpoint's collapse at pass
    24 on both paths."""
    from sniffles_tpu_torch.sim import fuzz_call_batch, sweep_layout_batches
    batch = {"fuzz 32768": lambda: fuzz_call_batch(1, 32768),
             "chain": lambda: fuzz_call_batch(99, 4096, svtypes=(1,))}.get(
        case, lambda: sweep_layout_batches()[case])()
    packed = torch.from_numpy(batch).to(card)
    inputs, state = tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(packed), 100), 100)
    m = candidate_cuts(inputs, state)
    assert m > 1
    for smem in (-1, m, m - 1, 0):
        counts = held_cuts(inputs, state, packed.shape[1], smem_cands=smem)
    assert bool(counts[4]) == (case == "cascade")
    if case == "cascade":
        assert int(counts[3]) == tc.MAX_CUT_PASSES


def test_sweep_cuts_past_the_threshold_by_default(card):
    """A task of more candidate cuts than a block's shared memory holds
    (fuzz at 2^20 slots: more words of them than threads) takes the global
    path by itself, with the plain partition's results; as one of k = 2
    tasks beside one that fits, each block its own path."""
    from sniffles_tpu_torch.sim import fuzz_call_batch
    n = 1 << 20
    tasks = []
    for seed, size in ((6, n), (2, 2048)):
        packed = torch.from_numpy(np.pad(fuzz_call_batch(seed, size), ((0, 0), (0, n - size))))
        tasks.append(tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(packed.to(card)),
                                                       100), 100))
    src = open(tc.__file__.replace("ops/clustering.py", "csrc/merge_sweep.cu")).read()
    threshold = int(src.split("constexpr int kSmemCands = ")[1].split(";")[0])
    assert candidate_cuts(*tasks[0]) > max(threshold, 32 * 1024)
    for inputs, state in tasks:
        held_cuts(inputs, state, n)
    stacked = [tc._stack_tasks([t[i] for t in tasks]) for i in (0, 1)]
    cut, heads, counts = tc.launch_sweep_cuts(*stacked, n, **CUTS)
    for t, (inputs, state) in enumerate(tasks):
        one_cut, one_heads, one_counts = tc.launch_sweep_cuts(inputs, state, n, **CUTS)
        live, segments = int(inputs["nseeds"][0]), int(one_counts[2])
        assert torch.equal(cut[t, :live].cpu(), one_cut[:live].cpu())
        assert torch.equal(heads[t, :segments].cpu(), one_heads[:segments].cpu())
        assert torch.equal(counts[t].cpu(), one_counts.cpu())


@pytest.mark.parametrize("mask", [0x00, 0x0A, 0xF5])
def test_head_masked_merge_sweep_matches_plain_version(card, mask):
    """The sweep with a head mask (a mesh shard's): one task a mask, then
    a stack of three tasks with three masks in one launch; every state
    array bit for bit and the counts equal the plain version's."""
    from sniffles_tpu_torch.sim import fuzz_call_batch
    batches = [fuzz_call_batch(2, 2048), fuzz_call_batch(3, 2048, svtypes=(4,)),
               fuzz_call_batch(4, 2048, svtypes=(0, 1))]
    masks = [mask, 0xFF, mask ^ 0xFF]
    tasks = [tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(
        torch.from_numpy(b).to(card)), 100), 100, m) for b, m in zip(batches, masks)]
    for inputs, state in [tasks[0], tuple(tc._stack_tasks([t[j] for t in tasks])
                                          for j in (0, 1))]:
        kernel = {k: v.clone() for k, v in state.items()}
        counts = tc.merge_sweep(inputs, kernel, **SWEEP).cpu()
        torch.cuda.synchronize()
        stacked = inputs["seed_type"].dim() == 2
        for t in range(len(tasks) if stacked else 1):
            row_in, row_state, row_kernel = ((tc._task_row(d, t) for d in (inputs, state, kernel))
                                             if stacked else (inputs, state, kernel))
            host_inputs = {k: v.cpu() for k, v in row_in.items()}
            assert int(host_inputs["head_mask"][0]) == masks[t]
            plain = {k: v.cpu().clone() for k, v in row_state.items()}
            want = tc.merge_sweep_plain(host_inputs, plain, **SWEEP)
            assert torch.equal(counts[t] if stacked else counts, want), t
            for k in tc.SWEEP_STATE:
                assert torch.equal(row_kernel[k].cpu().view(torch.int32),
                                   plain[k].view(torch.int32)), (t, k)


@pytest.fixture
def cards():
    """Two cards or more (a host of several), else a skip."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return [f"cuda:{i}" for i in range(min(4, torch.cuda.device_count()))]


def test_merge_sweep_on_another_card_matches_plain_version(cards):
    """The sweep of tensors on the last card (not the current device):
    its launches go to that card, in order with its stream; the state
    equals the plain version's bit for bit."""
    from sniffles_tpu_torch.sim import fuzz_call_batch
    packed = torch.from_numpy(fuzz_call_batch(2, 2048)).to(cards[-1])
    inputs, state = tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(packed), 100), 100,
                                    0x0A)
    kernel = {k: v.clone() for k, v in state.items()}
    counts = tc.merge_sweep(inputs, kernel, **SWEEP).cpu()
    plain = {k: v.cpu().clone() for k, v in state.items()}
    assert torch.equal(counts, tc.merge_sweep_plain({k: v.cpu() for k, v in inputs.items()},
                                                    plain, **SWEEP))
    for k in tc.SWEEP_STATE:
        assert torch.equal(kernel[k].cpu().view(torch.int32), plain[k].view(torch.int32)), k


def test_sharded_assign_on_distinct_cards_matches_the_cpu(cards):
    """The mesh call step with a shard on each card (the halo crosses
    between cards) gives the rows of the same step on CPU shards."""
    from sniffles_tpu_torch.parallel import device_call as tdc
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.sim import fuzz_call_batch
    packed = fuzz_call_batch(21, 4096)
    packed = packed[:, packed[5] > 0].copy()
    packed[3] = np.arange(packed.shape[1], dtype=np.int32)
    n = len(cards)
    payload = tdc.pack_mesh_payload((packed, META, [None] * packed.shape[1], None), n)
    args = (payload["shards"], payload["offsets"], payload["window_len"],
            np.full((n, 1), tdc.MESH_HALO_BP, dtype=np.int32))
    on_cards = tmesh.build_sharded_assign(cards, **META)(*args)
    on_cpu = tmesh.build_sharded_assign(["cpu"] * n, **META)(*args)
    assert on_cards["rows"].tolist() == on_cpu["rows"].tolist()
    assert on_cards["halo_overflow"].tolist() == on_cpu["halo_overflow"].tolist()


def test_sharded_assign_on_cuda_matches_the_cpu(card, monkeypatch):
    """The mesh call step as 4 shards on cuda:0 (mixed head masks among
    them) gives the rows and overflow flags of the same step on 4 CPU
    shards, bit for bit."""
    from sniffles_tpu_torch.parallel import device_call as tdc
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.sim import fuzz_call_batch
    packed = fuzz_call_batch(21, 4096)
    packed = packed[:, packed[5] > 0].copy()
    packed[3] = np.arange(packed.shape[1], dtype=np.int32)
    payload = tdc.pack_mesh_payload((packed, META, [None] * packed.shape[1], None), 4)
    masks, sweep = [], tc.merge_sweep

    def recorded(inputs, state, **params):
        masks.append(int(inputs["head_mask"][0]))
        return sweep(inputs, state, **params)
    monkeypatch.setattr(tc, "merge_sweep", recorded)
    halo_w = np.full((4, 1), tdc.MESH_HALO_BP, dtype=np.int32)
    args = (payload["shards"], payload["offsets"], payload["window_len"], halo_w)
    on_card = tmesh.build_sharded_assign(["cuda:0"] * 4, **META)(*args)
    on_cpu = tmesh.build_sharded_assign(["cpu"] * 4, **META)(*args)
    assert on_card["rows"].tolist() == on_cpu["rows"].tolist()
    assert on_card["halo_overflow"].tolist() == on_cpu["halo_overflow"].tolist()
    assert any(m not in (0, 0xFF) for m in masks), masks


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


def test_native_library_beside_a_cuda_context(card, monkeypatch, tmp_path):
    """The native host library in a process that holds a CUDA context: its
    BGZF inflate equals zlib's, and a CRAM of the sample called on the
    card gives the records of the native scan of its BAM and of the
    pure-Python scan (--no-native)."""
    import gzip
    from sniffles_tpu_torch import cli
    from sniffles_tpu_torch.io import native
    from sniffles_tpu_torch.sim import PlantedSV, write_cram, write_dataset

    torch.zeros(1, device=card)
    bam, fa = write_dataset(str(tmp_path), ref_len=150_000, depth=20, read_len=12_000,
                            seed=12, svs=[PlantedSV(pos=40_000, svtype="DEL", svlen=300),
                                          PlantedSV(pos=90_000, svtype="INS", svlen=200)])
    with open(bam, "rb") as f:
        raw = f.read()
    assert native.bgzf_inflate(raw) == gzip.decompress(raw)
    cram = write_cram(bam, fa)

    def records(path):
        with open(path) as f:
            return [line for line in f if not line.startswith("#")]

    monkeypatch.delenv("SNIFFLES_TPU_FORCE_CPU", raising=False)
    outs = []
    for inp, extra in ((bam, []), (bam, ["--no-native"]), (cram, [])):
        out = tmp_path / f"o{len(outs)}.vcf"
        assert cli.main(["--input", inp, "--reference", fa, "--threads", "0", "--vcf",
                         str(out), *extra]) == 0
        outs.append(records(out))
    assert len(outs[0]) == 2 and outs[0] == outs[1] == outs[2]


def test_batched_sweep_kernel_matches_plain_version(card):
    """One launch of each kernel over a stack of 4 tasks of one width, the
    third a zero pad slot: every slice's cut flags, counts and state equal
    its plain version's bit for bit, and the pad slot's state is left as
    it was."""
    from sniffles_tpu_torch.sim import fuzz_call_batch
    batches = [fuzz_call_batch(5, 2048), fuzz_call_batch(6, 2048, svtypes=(4,)),
               np.zeros((15, 2048), np.int32), fuzz_call_batch(7, 2048, svtypes=(1,))]
    tasks = [tc.sweep_inputs(*tc.sort_and_seed(tc.packed_signatures(
        torch.from_numpy(b).to(card)), 100), 100) for b in batches]
    inputs = tc._stack_tasks([t[0] for t in tasks])
    state = tc._stack_tasks([t[1] for t in tasks])
    cut, _, cut_counts = tc.launch_sweep_cuts(inputs, state, 2048, **CUTS)
    kernel = {k: v.clone() for k, v in state.items()}
    launches = dict(tc.COUNTS)
    counts = tc.merge_sweep(inputs, kernel, **SWEEP)
    torch.cuda.synchronize()
    assert tc.COUNTS == {k: v + 1 for k, v in launches.items()}
    assert counts.shape == (4, len(tc.SWEEP_COUNTS))
    for t, (task_inputs, task_state) in enumerate(tasks):
        host_inputs = {k: v.cpu() for k, v in task_inputs.items()}
        nseeds = int(host_inputs["nseeds"][0])
        plain_cut, _, plain_cut_counts = tc.sweep_cuts_plain(
            host_inputs, {k: v.cpu() for k, v in task_state.items()}, **CUTS)
        assert torch.equal(cut[t, :nseeds].cpu(), plain_cut[:nseeds]), t
        assert torch.equal(cut_counts[t].cpu(), plain_cut_counts), t
        plain = {k: v.cpu().clone() for k, v in task_state.items()}
        assert torch.equal(counts[t].cpu(), tc.merge_sweep_plain(host_inputs, plain, **SWEEP)), t
        for k in tc.SWEEP_STATE:
            got = kernel[k][t].cpu()
            assert torch.equal(got.view(torch.int32), plain[k].view(torch.int32)), (t, k)
            if nseeds == 0:
                assert torch.equal(got, task_state[k].cpu()), k
    assert int(inputs["nseeds"][2]) == 0 and counts[2].tolist() == [0, 0, 0, 1, 0]


def test_threaded_call_sample_on_cuda_matches_host(card, tmp_path):
    """--threads 2 in a process of its own (the CLI refuses to fork its
    workers from a process that holds a CUDA context): the records of the
    host path, every child's device statistics consumed, the sweep
    kernels launched by the parent's device service."""
    import json
    import os
    import subprocess
    import sys
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset

    svs = [PlantedSV(pos=p, svtype=k, svlen=ln) for p, k, ln in
           ((30_000, "DEL", 120), (60_000, "INS", 150), (90_000, "DUP", 900))]
    bam, fa = write_dataset(str(tmp_path), ref_len=120_000, depth=24, read_len=12_000,
                            seed=12, svs=svs, n_contigs=2)

    def run(label, extra):
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("SNIFFLES_TPU_FORCE_CPU", None)
        env["SNIFFLES_TPU_COUNTERS_JSON"] = str(tmp_path / f"{label}.json")
        vcf = tmp_path / f"{label}.vcf"
        r = subprocess.run([sys.executable, "-m", "sniffles_tpu_torch", "--input", bam,
                            "--reference", fa, "--vcf", str(vcf), *extra],
                           capture_output=True, text=True, env=env, timeout=600)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        with open(vcf) as f:
            return [line for line in f if not line.startswith("#")]

    host = run("host", ["--threads", "2", "--no-tpu"])
    dev = run("dev", ["--threads", "2"])
    counters = json.loads((tmp_path / "dev.json").read_text())
    assert len(host) >= len(svs) and dev == host
    assert counters["engine_consumed"] == counters["children_total"] > 0
    assert counters["device_tasks"] == 2
    # the warmup's step and one a dispatch (solo or fused)
    assert counters["kernel_merge_sweep"] == counters["kernel_sweep_cuts"] >= 2


@pytest.mark.parametrize("seed,size", [(1, 32768), (3, 512)])
def test_cluster_assign_on_cuda_matches_plain(card, seed, size):
    """cluster_assign_packed on the card (the sweep kernels, the resplit as
    torch ops) == on the CPU (the plain sweep), bit for bit."""
    from sniffles_tpu_torch.sim import fuzz_call_batch
    meta = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
                cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50, binsize=100,
                resplit_binsize=20)
    packed = torch.from_numpy(np.ascontiguousarray(fuzz_call_batch(seed, size)[[0, 1, 2, 8, 4,
                                                                                5]]))
    launches = tc.COUNTS["launches"]
    got = tc.cluster_assign_packed(packed.to(card), **meta).cpu()
    assert tc.COUNTS["launches"] == launches + 1
    assert torch.equal(got, tc.cluster_assign_packed(packed, **meta))


def test_flush_greedy_on_cuda_matches_plain(card):
    """run_combine_greedy on the card (the flush kernel, one launch a
    request) == on the CPU for every case of
    sniffles_tpu_torch.sim.greedy_flush_payloads, and of
    greedy_flush_wide_payloads, whose row's state is in global scratch."""
    from sniffles_tpu_torch.ops import combine_greedy as tcg
    from sniffles_tpu_torch.sim import greedy_flush_payloads, greedy_flush_wide_payloads
    for j, (payload, meta) in enumerate(greedy_flush_payloads()
                                        + greedy_flush_wide_payloads()):
        launches = tcg.COUNTS["launches"]
        got = tcg.run_combine_greedy(payload, meta, "cuda")
        assert tcg.COUNTS["launches"] == launches + 1, j
        want = tcg.run_combine_greedy(payload, meta, "cpu")
        assert got["assign"].tolist() == want["assign"].tolist(), j
        assert got["flags"].tolist() == want["flags"].tolist(), j


# the labels of sniffles_tpu_torch.sim.greedy_task_payloads
GREEDY_TASK_LABELS = [f"fuzz seed {k}" for k in range(6)] + [
    "exact ties", "near threshold", "ed miss", "width-1 table", "group overflow",
    "one long segment", "many segments", "group counts", "long group", "tiny ratios"]


def greedy_task_cases(label):
    from sniffles_tpu_torch.sim import greedy_task_payloads
    cases = [(p, m) for name, p, m in greedy_task_payloads() if name == label]
    assert cases, label
    return cases


@pytest.mark.parametrize("label", GREEDY_TASK_LABELS)
def test_grid_greedy_kernel_matches_plain(card, label):
    """The grid kernel on every payload of sim.greedy_task_payloads ==
    the plain version on the CPU, in assign and seg_flags: through
    run_combine_greedy_task (one launch a dispatch), and through the
    wrapper and launch_grid with no host synchronisation."""
    from sniffles_tpu_torch.ops import combine_greedy as tcg
    for payload, meta in greedy_task_cases(label):
        want = tcg.run_combine_greedy_task(payload, meta, "cpu")
        launches = tcg.COUNTS["launches"]
        got = tcg.run_combine_greedy_task(payload, meta, "cuda")
        assert tcg.COUNTS["launches"] == launches + 1
        for key in ("assign", "seg_flags"):
            assert got[key].tolist() == want[key].tolist(), (label, meta, key)
        grids = {k: torch.from_numpy(v).to(card) for k, v in tcg.task_grids(payload).items()}
        S, L = payload["c_pos"].shape
        gates = dict(cm=meta["cm"], cmm=meta["cmm"], limit=meta["limit"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tcg._greedy_grid_loop(*(grids[k] for k in tcg.GRID_KEYS), **gates)
            assign, segflags = tcg.launch_grid(tcg.grid_inputs(
                *(grids[k] for k in tcg.GRID_KEYS)), **gates)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert assign.cpu()[:S, :L].tolist() == want["assign"].tolist(), (label, meta)
        assert segflags.cpu()[:S].tolist() == want["seg_flags"].tolist(), (label, meta)


def test_greedy_kernel_refused_launch_raises(card):
    """A launch the card's entry points refuse (grid rows whose state
    would pass a block's 64 KB of shared memory, which grid_inputs also
    refuses; a flush whose ED table has no row) raises instead of
    returning stale memory."""
    from sniffles_tpu_torch.ops import combine_greedy as tcg
    S, L = 16, 4096
    grids = {k: torch.zeros((S, L), dtype=torch.int32, device=card)
             for k in ("c_pos", "c_len", "c_alt", "c_hord")}
    counts = torch.ones(S, dtype=torch.int32, device=card)
    ed = torch.full((S, 8, 1), -1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="past a block's shared memory"):
        tcg.grid_inputs(*grids.values(), counts, ed)
    gates = dict(cm=250, cmm=1000, limit=0.7)
    with pytest.raises(RuntimeError, match="combine_greedy launch failed"):
        tcg.launch_grid({**grids, "counts": counts, "ed": ed}, **gates)
    inputs = tcg.grid_inputs(*(g[:, :2048] for g in grids.values()), counts, ed)
    assign, _ = tcg.launch_grid(inputs, **gates)
    assert assign.cpu()[:, 0].tolist() == [0] * S
    z = torch.zeros(64, dtype=torch.int32, device=card)
    flush = tcg.flush_inputs(z, z, z, z, z, z, z,
                             torch.full((16, 64), -1, dtype=torch.int32, device=card))
    with pytest.raises(RuntimeError, match="combine_greedy launch failed"):
        tcg.launch_flush({**flush, "ed": flush["ed"][:0]}, 1, 0, **gates)


# ---------------------------------------------------------------------------
# the fused engine's kernels: the relaxation and the candidate tail

RELAX = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
             cluster_merge_bnd=1000, global_repeat=False, binsize=100)


def engine_sig(kind, size=4096):
    """Signature batches for the engine's kernels: synthetic sites, the
    36-link chain (the relaxation's 32-round cap binds), one segment, all
    slots invalid, a single slot."""
    from sniffles_tpu_torch.signatures import synthetic_batch
    from sniffles_tpu_torch.sim import relax_chain_positions
    if kind.startswith("synthetic"):
        return synthetic_batch(3000, 60, seed=int(kind[-1]), genome_span=2_000_000,
                               batch_size=size).as_dict()
    b = synthetic_batch(0, 1, seed=1, batch_size=size if kind != "single" else 1)
    sig = b.as_dict()
    pos = {"chain36": relax_chain_positions(36), "one-segment": list(range(5_000, 5_090, 3)),
           "all-invalid": [], "single": [7_000]}[kind]
    n = len(pos)
    sig["pos"][:n], sig["svlen"][:n], sig["valid"][:n] = pos, 100, True
    sig["read_id"][:n] = np.arange(n)
    return sig


ENGINE_KINDS = ["synthetic-1", "synthetic-2", "chain36", "one-segment", "all-invalid", "single"]


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_merge_relax_kernel_matches_plain_version(card, kind):
    from sniffles_tpu_torch.ops import merge_relax as tmr
    sig = {k: torch.as_tensor(v) for k, v in engine_sig(kind).items()}
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    want, want_rounds = tmr.merge_relax_plain(s, boundary, bin_, **RELAX)
    launches = tmr.COUNTS["launches"]
    got, rounds = tmr.merge_relax({k: v.to(card) for k, v in s.items()}, boundary.to(card),
                                  bin_.to(card), **RELAX)
    torch.cuda.synchronize()
    assert tmr.COUNTS["launches"] == launches + 1
    assert got.cpu().tolist() == want.tolist()
    assert int(rounds) == want_rounds
    if kind == "chain36":
        assert want_rounds == 32


def test_merge_relax_kernel_makes_no_host_sync(card):
    from sniffles_tpu_torch.ops import merge_relax as tmr
    sig = {k: torch.as_tensor(v).to(card) for k, v in engine_sig("chain36").items()}
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tmr.merge_relax(s, boundary, bin_, **RELAX)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_merge_relax_kernel_on_the_tiled_chain(card):
    """2^16 slots of tiled 36-link chains: the 32-round cap binds; one
    launch, no host synchronisation, the plain version's boundaries."""
    from sniffles_tpu_torch.ops import merge_relax as tmr
    from sniffles_tpu_torch.sim import relax_chain_batch
    sig = {k: torch.as_tensor(v) for k, v in relax_chain_batch(1 << 16).items()}
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    want, want_rounds = tmr.merge_relax_plain(s, boundary, bin_, **RELAX)
    s, boundary, bin_ = ({k: v.to(card) for k, v in s.items()}, boundary.to(card),
                         bin_.to(card))
    launches = tmr.COUNTS["launches"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, rounds = tmr.merge_relax(s, boundary, bin_, **RELAX)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tmr.COUNTS["launches"] == launches + 1
    assert want_rounds == tmr.MERGE_ITERS_MAX == int(rounds)
    assert got.cpu().tolist() == want.tolist()


def test_merge_relax_grid_and_stamps(card):
    """The cooperative grid is the card's resident grid (a whole number of
    blocks a multiprocessor), the same at every call; the kernel's time
    stamps rise through the rounds it ran."""
    from sniffles_tpu_torch.ops import merge_relax as tmr
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    blocks = tmr.resident_grid(card)
    assert blocks >= sms and blocks % sms == 0 and tmr.resident_grid(card) == blocks
    sig = {k: torch.as_tensor(v).to(card) for k, v in engine_sig("synthetic-1").items()}
    s, boundary, bin_ = tc.sort_and_seed(sig, 100)
    stamps = torch.zeros(tmr.STAMP_WORDS, dtype=torch.int64, device=card)
    _, rounds = tmr.launch_merge_relax(s, boundary, bin_, stamps=stamps, **RELAX)
    used = stamps[:2 * int(rounds) + 2].tolist()
    assert used[0] > 0 and used == sorted(used)
    assert not stamps[2 * int(rounds) + 2:].any()


def engine_params(flags):
    from sniffles_tpu_torch.parallel.engine import default_params
    p = default_params()
    if flags == "mosaic":
        p["mosaic"] = 1
    elif flags == "auto-qc-nm":
        p.update(minsupport_is_auto=1, qc_nm=1, qc_nm_threshold=0.02, coverage_global=27.5)
    return p


def held_tail(card, sig, params, cov_len=2_200_000, offset=0, ids_offset=0):
    """The tail on the card against its plain version on CPU copies of the
    same statistics (clustered on the CPU), every key bit for bit; one
    launch. `ids_offset`: the card's cluster ids in a view that many int32
    past a 16-byte boundary."""
    from sniffles_tpu_torch.ops import candidate_tail as ct
    from sniffles_tpu_torch.ops.segments import seg_sum
    sig = {k: torch.as_tensor(v) for k, v in sig.items()}
    clustered = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                      cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                      cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    stats = tc.call_statistics(clustered, fused=True)
    n = stats["svtype"].shape[0]
    support_sa = seg_sum((clustered["valid"] & (clustered["sa"] > 0)).to(torch.int32),
                         clustered["cluster_id"], n)
    rng = np.random.default_rng(4)
    coverage = torch.as_tensor(rng.integers(0, 60, cov_len).astype(np.int32))
    want = ct.candidate_tail(stats, support_sa, coverage, clustered, params,
                             region_offset=offset)
    launches = ct.COUNTS["launches"]
    elements = {k: v.to(card) for k, v in clustered.items() if isinstance(v, torch.Tensor)}
    elements["cluster_id"] = view_at(elements["cluster_id"], ids_offset)
    got = ct.candidate_tail({k: v.to(card) if isinstance(v, torch.Tensor) else v
                             for k, v in stats.items()}, support_sa.to(card),
                            coverage.to(card), elements, params, region_offset=offset)
    torch.cuda.synchronize()
    assert ct.COUNTS["launches"] == launches + 1
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].cpu()
        assert g.dtype == v.dtype, k
        if v.dtype == torch.float32:
            assert g.view(torch.int32).tolist() == v.view(torch.int32).tolist(), k
        else:
            assert g.tolist() == v.tolist(), k


def view_at(t, offset):
    """t's values in a view `offset` elements into a fresh buffer (its data
    pointer offset * 4 bytes past the allocator's 512-byte boundary)."""
    buf = torch.full((t.shape[0] + offset,), -99, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


@functools.lru_cache(maxsize=1)
def tail_layouts_2_21():
    from sniffles_tpu_torch.sim import tail_run_layouts
    return tail_run_layouts(1 << 21)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("label", list(tail_run_layouts(700)))
def test_tail_runs_kernel_matches_plain_version(card, label, offset):
    """The tail's run pass alone on sim.tail_run_layouts at 2^21 ids, in a
    view at each 16-byte offset: its written starts == tail_runs_plain bit
    for bit (the plain version's torch.searchsorted on the card)."""
    from sniffles_tpu_torch.ops import candidate_tail as ct
    cid = view_at(torch.as_tensor(tail_layouts_2_21()[label]).to(card), offset)
    assert cid.data_ptr() % 16 == 4 * offset
    want = ct.tail_runs_plain(cid)
    got = ct.launch_tail_runs(cid)
    torch.cuda.synchronize()
    assert torch.equal(got[:want.shape[0]], want)


def test_tail_runs_kernel_on_the_engine_batch(card):
    """The run pass on the cluster ids the engine's 2^16 step hands its
    tail, at each 16-byte offset, == tail_runs_plain."""
    from sniffles_tpu_torch.ops import candidate_tail as ct
    from sniffles_tpu_torch.tools.profile_engine import engine_inputs, tail_ids
    cid = tail_ids(*engine_inputs(1 << 16, "cuda"))
    want = ct.tail_runs_plain(cid)
    assert want.shape[0] > 1000
    for offset in range(4):
        got = ct.launch_tail_runs(view_at(cid, offset))
        torch.cuda.synchronize()
        assert torch.equal(got[:want.shape[0]], want), offset


@pytest.mark.parametrize("flags", ["default", "mosaic", "auto-qc-nm"])
@pytest.mark.parametrize("kind", ["synthetic-3", "all-invalid", "outside"])
def test_candidate_tail_kernel_matches_plain_version(card, kind, flags):
    """"outside": a coverage window shorter than the sites' span and
    offset, so probes fall on both sides of it."""
    sig = engine_sig("synthetic-3" if kind == "outside" else kind)
    cov_len, offset = (400_000, 300_000) if kind == "outside" else (2_200_000, 0)
    held_tail(card, sig, engine_params(flags), cov_len, offset)


@pytest.mark.parametrize("ids_offset", [1, 2, 3])
def test_candidate_tail_kernel_on_a_misaligned_view(card, ids_offset):
    """The whole tail with its cluster ids in a view off the 16-byte
    boundary (a shard's, say): its run pass reads them by scalar loads up
    to the boundary."""
    held_tail(card, engine_sig("synthetic-3"), engine_params("default"), ids_offset=ids_offset)


@pytest.mark.parametrize("flags", ["default", "mosaic", "auto-qc-nm"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 1 << 16])
def test_candidate_tail_kernel_at_odd_widths(card, n, flags):
    """Widths that are not a multiple of the kernel's blocks or vectors: a
    single slot, one either side of 4,096, and 2^16 (most slots hold no
    cluster)."""
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = synthetic_batch(max(n * 3 // 4, 1), max(n // 40, 1), seed=n % 97,
                          genome_span=2_000_000, batch_size=n).as_dict()
    held_tail(card, sig, engine_params(flags))


def test_engine_step_on_cuda_matches_the_cpu(card):
    """call_pipeline_step on the card == on the CPU, every key bit for bit;
    each kernel launched once."""
    from sniffles_tpu_torch.ops import candidate_tail as ct, merge_relax as tmr
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    sig = engine_sig("synthetic-2")
    coverage = np.full(2_200_000, 30, dtype=np.int32)
    params = engine_params("default")
    want = call_pipeline_step(sig, coverage, params, device="cpu")
    before = (tmr.COUNTS["launches"], ct.COUNTS["launches"])
    got = call_pipeline_step(sig, coverage, params, device=card)
    torch.cuda.synchronize()
    assert (tmr.COUNTS["launches"], ct.COUNTS["launches"]) == (before[0] + 1, before[1] + 1)
    for k, v in want.items():
        g = got[k].cpu()
        assert g.dtype == v.dtype, k
        if v.dtype == torch.float32:
            assert g.view(torch.int32).tolist() == v.view(torch.int32).tolist(), k
        else:
            assert g.tolist() == v.tolist(), k


def test_engine_step_spans_hold_its_launches(card):
    """The engine's 2^21 step under CPU and CUDA activity: its spans are
    host ranges alone (no device event bears a span's name); the launch
    call of each kernel and copy (the call that shares its correlation id)
    lies inside the step, so each falls in one of its five stages or its
    own time; the step makes 111 launch and copy calls. Replayed, the
    step makes no kernel launch call and opens no stage, one graph launch
    inside its replay span."""
    from sniffles_tpu_torch.parallel import engine
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    from sniffles_tpu_torch.spans import REPLAY, STAGES, STEP
    from sniffles_tpu_torch.tools.profile_engine import (LAUNCH_CALLS, engine_inputs,
                                                         launched_by, stage_split)
    sig, coverage, params = engine_inputs(1 << 21, "cuda")
    call_pipeline_step(sig, coverage, params)
    torch.cuda.synchronize()
    # the profiled call a first sight again: the eager body
    engine.clear_graphs()
    eager = engine.COUNTS["eager"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call_pipeline_step(sig, coverage, params)
        torch.cuda.synchronize()
    assert engine.COUNTS["eager"] == eager + 1
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    named = {STEP, *STAGES}
    assert not [e.name for e in events if e.device_type == cuda and e.name in named]
    step = [e.time_range for e in events if e.device_type != cuda and e.name == STEP]
    assert len(step) == 1
    lo, hi = step[0].start, step[0].end
    pairs = launched_by(events)
    assert pairs and all(call is not None for _, call in pairs)
    for kernel, call in pairs:
        assert lo <= call.time_range.start <= hi, kernel.name
    split = stage_split(events, 1)
    assert set(split) == named
    assert sum(v[1] for v in split.values()) == len(pairs)
    launches = [e for e in events if e.device_type != cuda and e.name.startswith(LAUNCH_CALLS)
                and lo <= e.time_range.start <= hi]
    assert len(launches) == 111
    # the second sight captures, the third replays: no kernel launch call
    # inside the replayed step, one graph launch in its replay span
    call_pipeline_step(sig, coverage, params)
    torch.cuda.synchronize()
    replays = engine.COUNTS["replays"]
    with torch.profiler.profile(activities=acts) as prof:
        call_pipeline_step(sig, coverage, params)
        torch.cuda.synchronize()
    assert engine.COUNTS["replays"] == replays + 1
    events = prof.events()
    (step,) = [e.time_range for e in events if e.device_type != cuda and e.name == STEP]
    (replay,) = [e.time_range for e in events if e.device_type != cuda and e.name == REPLAY]
    assert step.start <= replay.start <= replay.end <= step.end
    inside = [e.name for e in events if e.device_type != cuda
              and step.start <= e.time_range.start <= step.end]
    assert not [n for n in inside if n.startswith(("cudaLaunch", "cuLaunch"))], inside
    assert sum(n.startswith(("cudaGraphLaunch", "cuGraphLaunch")) for n in inside) == 1
    assert not [e.name for e in events if e.device_type != cuda and e.name in STAGES]
    engine.clear_graphs()


def engine_host_batches():
    """The benchmark cell's four batches of 2^21 slots (its traffic
    chr1-sites-2m, seed 7, and its coverage and parameters), and a 2^16
    batch of synthetic sites, on the host: ("label", sig, coverage,
    params) of numpy arrays."""
    import json
    import os
    import types
    from benchmark.traffic.generate import coverage, signature_batches
    from sniffles_tpu_torch.parallel.engine import default_params
    from sniffles_tpu_torch.signatures import synthetic_batch
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "traffic", "chr1-sites-2m.json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "benchmark", "configs", "hg002-hifi30.json")) as f:
        conf = json.load(f)["engine"]
    params = default_params(types.SimpleNamespace(**conf["params"]))
    params["coverage_global"] = float(conf["coverage_global"])
    cov = coverage(mix)
    out = [(f"chr1-sites-2m[{b}]", batch, cov, params)
           for b, batch in enumerate(signature_batches(mix, 7))]
    n = 1 << 16
    sig = synthetic_batch(n, n // 40, seed=42, genome_span=900_000, batch_size=n).as_dict()
    return out + [("synthetic 2^16", sig, np.full(1_000_000, 30, dtype=np.int32),
                   default_params())]


def engine_graph_batches():
    """engine_host_batches on the card."""
    from sniffles_tpu_torch.parallel.engine import to_device
    return [(label, *to_device(sig, cov, "cuda"), params)
            for label, sig, cov, params in engine_host_batches()]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_step(got: dict, want: dict, label: str) -> None:
    assert got.keys() == want.keys(), label
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (label, k)
        assert torch.equal(bits(got[k]), bits(v)), (label, k)


def test_engine_step_replays_equal_the_eager_step(card):
    """Each batch: the first sight eager, the second a capture, then
    replays, every output key and merge_rounds bit for bit equal to the
    eager body's; after an in-place refill of a batch's inputs with
    another batch's, its replay equals the eager step on the new inputs;
    a held output is not overwritten (that call runs eagerly)."""
    from sniffles_tpu_torch.parallel import engine
    engine.clear_graphs()
    batches = engine_graph_batches()
    counts = dict(engine.COUNTS)
    for label, sig, coverage, params in batches:
        want_info = {}
        want = engine._eager_step(sig, coverage, params, 0, 100, 20, None, want_info)
        for call in range(4):
            info = {}
            got = engine.call_pipeline_step(sig, coverage, params, info=info)
            assert_same_step(got, want, f"{label} call {call}")
            assert int(info["merge_rounds"]) == int(want_info["merge_rounds"]), label
            del got
    n = len(batches)
    assert engine.COUNTS["eager"] == counts["eager"] + n
    assert engine.COUNTS["captures"] == counts["captures"] + n
    assert engine.COUNTS["replays"] == counts["replays"] + 2 * n
    assert engine.COUNTS["capture_fallbacks"] == counts["capture_fallbacks"]

    # batch 0's tensors refilled in place with batch 1's contents
    (_, sig0, coverage, params), (_, sig1, _, _) = batches[:2]
    for k, v in sig0.items():
        v.copy_(sig1[k])
    want = engine._eager_step(sig1, coverage, params, 0, 100, 20, None, None)
    replays = engine.COUNTS["replays"]
    got = engine.call_pipeline_step(sig0, coverage, params)
    assert engine.COUNTS["replays"] == replays + 1
    assert_same_step(got, want, "refilled batch 0")

    # the refill's outputs are held: the next call runs eagerly and leaves them
    kept = {k: v.clone() for k, v in got.items()}
    held = engine.COUNTS["held_outputs"]
    again = engine.call_pipeline_step(sig0, coverage, params)
    assert engine.COUNTS["held_outputs"] == held + 1
    assert again["pos"].data_ptr() != got["pos"].data_ptr()
    torch.cuda.synchronize()
    assert_same_step(got, kept, "held outputs")
    assert_same_step(again, want, "the eager step beside held outputs")
    del got, again
    torch.cuda.synchronize()
    assert_same_step(engine.call_pipeline_step(sig0, coverage, params), want, "replay after")
    engine.clear_graphs()


def test_engine_step_on_batches_moved_anew_each_step(card):
    """A caller that moves each step's batch from the host anew
    (to_device), as a loop over contigs does, in two ways: the last batch
    and its outputs still held while the next is moved (a plain loop's
    assignment), and both dropped first. Every call equals the eager body
    on its batch; prints each call's path and the share replayed (only
    where the caching allocator hands back the storage of an earlier
    batch does a call replay)."""
    from sniffles_tpu_torch.parallel import engine
    host = engine_host_batches()
    calls = 12
    for group in (host[:4], host[4:]):
        want = [{k: v.cpu() for k, v in engine._eager_step(
                    *engine.to_device(sig, cov, "cuda"), params, 0, 100, 20, None,
                    None).items()}
                for _, sig, cov, params in group]
        for drop in (False, True):
            engine.clear_graphs()
            paths, dsig = [], None
            for i in range(calls):
                label, sig, cov, params = group[i % len(group)]
                if drop:
                    dsig = dcov = out = None
                before = dict(engine.COUNTS)
                dsig, dcov = engine.to_device(sig, cov, "cuda")
                out = engine.call_pipeline_step(dsig, dcov, params)
                paths.extend(k for k in ("eager", "captures", "replays")
                             if engine.COUNTS[k] != before[k])
                assert_same_step({k: v.cpu() for k, v in out.items()},
                                 want[i % len(group)], f"{label} call {i}")
            print(f"{group[0][0]} and on, {calls} calls moved anew, "
                  f"{'dropped' if drop else 'held'} before the next: {paths}; replayed "
                  f"{paths.count('replays') / calls:.0%}")
            assert len(paths) == calls, paths
            del dsig, dcov, out
    engine.clear_graphs()


def test_engine_step_replays_count_the_eager_launches(card):
    """After N replays, the ops modules' COUNTS have grown by N eager
    steps' launches."""
    from sniffles_tpu_torch.parallel import engine
    from sniffles_tpu_torch.tools.profile_engine import engine_inputs
    engine.clear_graphs()
    sig, coverage, params = engine_inputs(1 << 16, "cuda")

    def snapshot():
        return {mod.__name__: dict(mod.COUNTS) for mod in engine.COUNTED}

    def grown(before, after):
        return {m: {k: after[m][k] - before[m][k] for k in after[m]} for m in after}

    before = snapshot()
    engine.call_pipeline_step(sig, coverage, params)
    one = grown(before, snapshot())
    assert one["sniffles_tpu_torch.ops.merge_relax"]["launches"] == 1
    engine.call_pipeline_step(sig, coverage, params)       # the capture
    before = snapshot()
    replays = engine.COUNTS["replays"]
    for _ in range(5):
        engine.call_pipeline_step(sig, coverage, params)
    torch.cuda.synchronize()
    assert engine.COUNTS["replays"] == replays + 5
    assert grown(before, snapshot()) == {m: {k: 5 * v for k, v in c.items()}
                                         for m, c in one.items()}
    engine.clear_graphs()


def test_engine_step_capture_that_raises_falls_back(card, monkeypatch):
    """A launcher rebound to one that waits for the card cannot be
    captured: that call and the key's later ones run eagerly, counted, and
    equal the eager step."""
    from sniffles_tpu_torch.ops import call_stats
    from sniffles_tpu_torch.parallel import engine
    from sniffles_tpu_torch.tools.profile_engine import engine_inputs
    engine.clear_graphs()
    sig, coverage, params = engine_inputs(1 << 16, "cuda")
    want = engine._eager_step(sig, coverage, params, 0, 100, 20, None, None)
    keys = call_stats.sort_keys

    def waiting(clustered):
        out = keys(clustered)
        int(out[0])
        return out
    monkeypatch.setattr(call_stats, "sort_keys", waiting)
    fallbacks, captures = engine.COUNTS["capture_fallbacks"], engine.COUNTS["captures"]
    for _ in range(3):
        assert_same_step(engine.call_pipeline_step(sig, coverage, params), want, "fallback")
    assert engine.COUNTS["capture_fallbacks"] == fallbacks + 1
    assert engine.COUNTS["captures"] == captures
    monkeypatch.undo()
    # the launcher restored: a new launcher key, captured at once
    assert_same_step(engine.call_pipeline_step(sig, coverage, params), want, "restored")
    assert engine.COUNTS["captures"] == captures + 1
    engine.clear_graphs()


def test_sharded_step_on_cuda_matches_the_cpu(card):
    """build_sharded_step with 4 shards on the card == 4 CPU shards: every
    integer output and the overflow flags."""
    from sniffles_tpu_torch.parallel.engine import default_params
    from sniffles_tpu_torch.parallel.mesh import build_sharded_step, shard_batch
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = shard_batch(synthetic_batch(4000, 80, seed=3, genome_span=400_000,
                                      batch_size=4096).as_dict(), 4)
    coverage = np.full(4 * 131072, 30, dtype=np.int32)
    offs = np.arange(4, dtype=np.int32) * 131072
    runs = [build_sharded_step([d] * 4, default_params(), halo_bp=2000, halo_slots=256)(
        sig, coverage, offs) for d in ("cpu", card)]
    for k, v in runs[0].items():
        if v.dtype != np.float32:
            assert runs[1][k].tolist() == v.tolist(), k


# ---------------------------------------------------------------------------
# the call statistics: the run pass, then a thread, a warp or a block a
# cluster by its size

CALL_STATS_BATCHES = [("random", 1024, 1), ("random", 8192, 3), ("edge", 8192, 4),
                      ("edge", 8192, 5), ("tiers", 65536, 8), ("huge", 32768, 9),
                      ("sums", 65536, 10)]


def call_stats_inputs(kind, n, seed):
    """tests/test_torch_call_stats.py's batches, or "engine": the engine's
    clustered 2^16 batch (synthetic_batch, n/40 sites, seed 42), as CPU
    tensors."""
    from sniffles_tpu_torch.sim import call_stats_batch
    if kind != "engine":
        return {k: torch.as_tensor(v) for k, v in call_stats_batch(kind, n, seed).items()}
    from sniffles_tpu_torch.signatures import synthetic_batch
    sig = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        n, n // 40, seed=seed, genome_span=900_000, batch_size=n).as_dict().items()}
    clustered = tc.cluster_signatures(sig, cluster_r=2.5, cluster_repeat_h=1.5,
                                      cluster_repeat_h_max=1000.0, cluster_merge_bnd=1000,
                                      cluster_merge_len=0.22, minsvlen=50, exact_sweep=False)
    clustered.pop("merge_rounds")
    return clustered


def held_call_stats(card, clustered, fused):
    """The kernels on the card against the plain version on the CPU copies,
    every key and slot bit for bit, and against the plain version on the
    card in the integer keys (its float32 sums add with atomics there); one
    launch, no host synchronisation inside the wrapper."""
    from sniffles_tpu_torch.ops import call_stats as cs
    want = cs.call_statistics_plain(clustered, fused)
    on_card = {k: v.to(card) for k, v in clustered.items()}
    plain_card = cs.call_statistics_plain(on_card, fused)
    launches = cs.COUNTS["launches"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cs.call_statistics(on_card, fused)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cs.COUNTS["launches"] == launches + 1
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].cpu()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        if v.dtype == torch.float32:
            assert g.view(torch.int32).tolist() == v.view(torch.int32).tolist(), k
        else:
            assert g.tolist() == v.tolist(), k
            assert plain_card[k].cpu().tolist() == v.tolist(), k


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,n,seed", CALL_STATS_BATCHES + [("engine", 1 << 16, 42)])
def test_call_stats_kernel_matches_plain_version(card, kind, n, seed, fused):
    held_call_stats(card, call_stats_inputs(kind, n, seed), fused)


def test_call_stats_kernel_on_a_single_slot_and_all_invalid(card):
    """One slot (a cluster of one), and a batch with no valid element
    (every slot empty or invalid-only)."""
    one = {k: v[:1].clone() for k, v in call_stats_inputs("random", 1024, 1).items()
           if k != "n_clusters"}
    one["valid"][:] = True
    one["cluster_id"][:] = 0
    one["n_clusters"] = torch.tensor(1, dtype=torch.int32)
    held_call_stats(card, one, True)
    none = call_stats_inputs("random", 1024, 2)
    none["valid"][:] = False
    held_call_stats(card, none, False)


# the run pass's layouts (tests/test_torch_run_layout.py's, at the card's
# tile): (n, cluster ids, valid flags) over call_stats_batch's columns
def _run_layouts():
    rng = np.random.default_rng(20)
    big = 1 << 17
    return {
        "n=1 valid": (1, [0], [True]),
        "n=1 invalid": (1, [0], [False]),
        "n off the tile": (2049, rng.integers(0, 700, 2049), rng.random(2049) < 0.8),
        "all invalid": (3001, rng.integers(0, 3000, 3001), np.zeros(3001, dtype=bool)),
        "one cluster of n": (4099, np.zeros(4099, dtype=int), np.ones(4099, dtype=bool)),
        "the last slot live": (4097, [4096] * 3 + [0] * 4094, np.ones(4097, dtype=bool)),
        "K a slot": (5000, np.arange(5000) // 37, np.ones(5000, dtype=bool)),
        "diagonals inside runs": (big, rng.permutation(np.arange(big) // 3000),
                                  rng.random(big) < 0.9),
    }


RUN_LAYOUTS = list(_run_layouts())


def run_layout_batch(label):
    """call_stats_batch("random")'s columns (CPU tensors) with a run
    layout's n, cluster ids and valid flags."""
    from sniffles_tpu_torch.sim import call_stats_batch
    n, cid, valid = _run_layouts()[label]
    b = {k: torch.as_tensor(v) for k, v in call_stats_batch("random", max(n, 1024), 11).items()}
    b = {k: v if k == "n_clusters" else v[:n].clone() for k, v in b.items()}
    b["cluster_id"] = torch.as_tensor(np.asarray(cid, dtype=np.int32))
    b["valid"] = torch.as_tensor(np.asarray(valid, dtype=bool))
    return b


@pytest.mark.parametrize("label", RUN_LAYOUTS)
def test_call_stats_on_the_run_layouts(card, label):
    """The whole statistics on the run pass's edge layouts == the plain
    version, every key and slot (fused and not), and the sort's keys of
    the kernel stat_keys == sort_keys_plain's."""
    from sniffles_tpu_torch.ops import call_stats as cs
    b = run_layout_batch(label)
    keys = cs.sort_keys({k: b[k].to(card) for k in ("cluster_id", "valid")})
    assert keys.cpu().tolist() == cs.sort_keys_plain(b).tolist()
    for fused in (False, True):
        held_call_stats(card, b, fused)


# thresholds (tiny, pair, warp, block) that send the clusters of every
# crafted batch through other tiers, each a build of its own; and one whose
# block tier the card's shared memory refuses
TIER_VARIANTS = [(0, 0, 1, 1), (8, 0, 8, 8), (0, 64, 64, 64), (1, 0, 1024, 4096)]
REFUSED_TIERS = (8, 64, 256, 20_000)


@pytest.fixture(scope="module")
def tier_builds():
    """The call-statistics builds of TIER_VARIANTS and REFUSED_TIERS, one
    nvcc each, started together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import call_stats as cs
    started = [_build.start_build("call_stats", defines=cs.nvcc_defines(t))
               for t in TIER_VARIANTS + [REFUSED_TIERS]]
    for s in started:
        _build.finish_build(s)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tiers", TIER_VARIANTS,
                         ids=["all-past-shared", "tiny-then-past", "warp-then-past",
                              "block-to-4096"])
def test_call_stats_each_tier_on_every_batch(card, tier_builds, tiers, fused):
    """Thresholds that send the clusters of every crafted batch through
    other tiers: (0, 0, 1, 1) every cluster of 2 or more to the block
    tier's global scratch, (8, 0, 8, 8) the thread tier, then that scratch,
    (0, 64, 64, 64) a warp's registers up to 64, then that scratch, (1, 0,
    1024, 4096) a warp's shared memory for 2 to 1,024; the kernels == the
    plain version on CPU copies, every key and slot."""
    from sniffles_tpu_torch.ops import call_stats as cs
    for kind, n, seed in CALL_STATS_BATCHES:
        clustered = call_stats_inputs(kind, n, seed)
        want = cs.call_statistics_plain(clustered, fused)
        inputs = cs.kernel_inputs({k: v.to(card) for k, v in clustered.items()})
        got = cs.launch_kernels(inputs, want["n_clusters"], fused, tiers)
        for k, v in want.items():
            g = got[k].cpu() if isinstance(got[k], torch.Tensor) else got[k]
            if k != "n_clusters" and v.dtype == torch.float32:
                g, v = g.view(torch.int32), v.view(torch.int32)
            assert torch.equal(torch.as_tensor(g), torch.as_tensor(v)), (kind, seed, k)


def test_call_stats_singletons_and_a_refused_shared_memory(card, tier_builds):
    """Every slot a cluster of one (the thread tier alone) == the plain
    version; a block tier larger than a block's shared memory raises."""
    from sniffles_tpu_torch.ops import call_stats as cs
    clustered = call_stats_inputs("random", 8192, 3)
    clustered["valid"][:] = True
    clustered["cluster_id"] = torch.arange(8192, dtype=torch.int32)
    clustered["n_clusters"] = torch.tensor(8192, dtype=torch.int32)
    held_call_stats(card, clustered, True)
    inputs = cs.kernel_inputs({k: v.to(card) for k, v in clustered.items()})
    with pytest.raises(RuntimeError, match="call_stats launch failed"):
        cs.launch_kernels(inputs, clustered["n_clusters"], True, REFUSED_TIERS)


def test_call_statistics_kernel_runs_on_the_three_paths(card, monkeypatch):
    """call_task_packed (a call task), build_sharded_assign (the call path's
    mesh step, 4 shards) and call_pipeline_step (the engine) each launch
    the kernels on CUDA tensors, one launch a statistics call, and give the
    CPU's results."""
    from sniffles_tpu_torch.ops import call_stats as cs
    from sniffles_tpu_torch.parallel import device_call as tdc
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    from sniffles_tpu_torch.sim import fuzz_call_batch
    from sniffles_tpu_torch.ops.transfer import to_device
    packed = fuzz_call_batch(7, 4096)
    before = cs.COUNTS["launches"]
    got = tc.call_task_packed(to_device(packed, card), **META)
    torch.cuda.synchronize()
    assert cs.COUNTS["launches"] == before + 1
    assert got.cpu().tolist() == tc.call_task_packed(torch.as_tensor(packed), **META).tolist()

    packed = packed[:, packed[5] > 0].copy()
    packed[3] = np.arange(packed.shape[1], dtype=np.int32)
    payload = tdc.pack_mesh_payload((packed, META, [None] * packed.shape[1], None), 4)
    args = (payload["shards"], payload["offsets"], payload["window_len"],
            np.full((4, 1), tdc.MESH_HALO_BP, dtype=np.int32))
    before = cs.COUNTS["launches"]
    on_card = tmesh.build_sharded_assign(["cuda:0"] * 4, **META)(*args)
    assert cs.COUNTS["launches"] == before + 4
    assert on_card["rows"].tolist() == tmesh.build_sharded_assign(["cpu"] * 4, **META)(
        *args)["rows"].tolist()

    sig = engine_sig("synthetic-2")
    coverage = np.full(2_200_000, 30, dtype=np.int32)
    before = cs.COUNTS["launches"]
    got = call_pipeline_step(sig, coverage, engine_params("default"), device=card)
    torch.cuda.synchronize()
    assert cs.COUNTS["launches"] == before + 1
    want = call_pipeline_step(sig, coverage, engine_params("default"), device="cpu")
    for k in ("stdev_pos", "stdev_len", "support", "svlen", "pos", "qual"):
        assert got[k].cpu().view(torch.int32).tolist() == want[k].view(torch.int32).tolist(), k


# ---------------------------------------------------------------------------
# the clustering's segmented sorts (csrc/cluster_sorts.cu): the run pass and
# the thread tier, the warp and block tiers, the gather


def seg_sort_case(kind, seed=5):
    """sim.seg_sort_batch's population as the callers give it: segment
    starts, the keys masked to INT32_MAX where not valid, the invalid
    elements (CPU tensors)."""
    from sniffles_tpu_torch.sim import seg_sort_batch, seg_sort_width
    b = seg_sort_batch(kind, seg_sort_width(kind), seed)
    valid = torch.from_numpy(b["valid"])
    big = 2 ** 31 - 1
    k1 = torch.where(valid, torch.from_numpy(b["k1"]), big)
    k2 = torch.where(valid, torch.from_numpy(b["k2"]), big)
    return tc._starts(torch.from_numpy(b["seg_id"])), k1, k2, ~valid


def held_seg_sort(card, seg_start, k1, k2=None, base=None, alone=None, tiers=None):
    """The kernels on the card (one seg_sort call, no host synchronisation
    inside the wrapper) == the plain version on the CPU, every element."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    want = cso.seg_sort_plain(seg_start, k1, k2, base, alone)
    args = [None if t is None else t.to(card) for t in (seg_start, k1, k2, base, alone)]
    before = dict(cso.COUNTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (cso.seg_sort(*args) if tiers is None
               else cso.launch_seg_sort(*args, tiers=tiers))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if tiers is None:
        assert cso.COUNTS["seg_sort"] == before["seg_sort"] + 1
        assert cso.COUNTS["seg_runs"] == before["seg_runs"] + 1
        assert cso.COUNTS["seg_tiers"] == before["seg_tiers"] + 1
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)


SEG_SORT_KINDS = ["tiers", "random", "equal", "limits", "invalid", "huge", "packed", "tiles"]


@pytest.mark.parametrize("kind", SEG_SORT_KINDS)
def test_seg_sort_kernel_matches_plain_version(card, kind):
    """Every sim.seg_sort_batch population (each tier threshold from both
    sides, presorted and all-equal segments, keys at the int32 limits, no
    valid element, a segment of 2^20, the warp tier's packed segments of 9
    to 64, the run pass's tile edges), with two keys, one key and through a
    base permutation."""
    seg_start, k1, k2, invalid = seg_sort_case(kind)
    held_seg_sort(card, seg_start, k1, k2)
    held_seg_sort(card, seg_start, k1)
    held_seg_sort(card, seg_start, k1, k2, alone=invalid)
    # every segment of one element marked alone too (between "packed"'s
    # packed segments)
    seg_id = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    single = torch.bincount(seg_id)[seg_id] == 1
    held_seg_sort(card, seg_start, k1, k2, alone=invalid | single)
    base = torch.from_numpy(np.random.default_rng(1).permutation(k1.shape[0]))
    inverse = torch.argsort(base)
    held_seg_sort(card, seg_start, k1[inverse], k2[inverse], base)
    held_seg_sort(card, seg_start, k1[inverse], k2[inverse], base, invalid[inverse])


# thresholds (tiny, warp, block) that send the populations' segments
# through other tiers, each a build of its own; and one whose block tier the
# card's shared memory refuses
SORT_TIER_VARIANTS = [(1, 1, 1), (8, 8, 8), (1, 32, 32), (2, 512, 16384)]
REFUSED_SORT_TIERS = (8, 256, 20_000)


@pytest.fixture(scope="module")
def sort_tier_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sniffles_tpu_torch.ops import _build
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    started = [_build.start_build("cluster_sorts", defines=cso.nvcc_defines(t))
               for t in SORT_TIER_VARIANTS + [REFUSED_SORT_TIERS]]
    for s in started:
        _build.finish_build(s)


@pytest.mark.parametrize("tiers", SORT_TIER_VARIANTS,
                         ids=["all-past-shared", "tiny-then-past", "warp-then-past",
                              "block-to-16384"])
def test_seg_sort_each_tier_on_every_population(card, sort_tier_builds, tiers):
    """(1, 1, 1): every segment of 2 or more to the block tier's global
    scratch; (8, 8, 8): the thread tier, then that scratch; (1, 32, 32): a
    warp up to 32, then that scratch; (2, 512, 16384): a warp up to 512, a
    block's shared memory up to 16,384: the kernels == the plain version."""
    for kind in ("tiers", "random", "equal", "limits", "packed", "tiles"):
        seg_start, k1, k2, invalid = seg_sort_case(kind, seed=7)
        held_seg_sort(card, seg_start, k1, k2, tiers=tiers)
        held_seg_sort(card, seg_start, k1, k2, alone=invalid, tiers=tiers)


def test_seg_sort_events_time_its_parts(card):
    """The entry point records a timing tool's three events around the run
    pass and the tiers, and gives the same permutation."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    seg_start, k1, k2, invalid = seg_sort_case("random")
    want = cso.seg_sort_plain(seg_start, k1, k2, None, invalid)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(cso.SORT_EVENTS)]
    for e in evs:
        e.record()
    got = cso.launch_seg_sort(seg_start.to(card), k1.to(card), k2.to(card),
                              alone=invalid.to(card), events=evs)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert cso.SORT_EVENTS == len(cso.SORT_EVENT_PARTS) + 1
    assert all(evs[i].elapsed_time(evs[i + 1]) > 0 for i in range(len(evs) - 1))


def test_seg_sort_refused_shared_memory_raises(card, sort_tier_builds):
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    seg_start, k1, _, _ = seg_sort_case("random")
    with pytest.raises(RuntimeError, match="seg_sort launch failed"):
        cso.launch_seg_sort(seg_start.to(card), k1.to(card), tiers=REFUSED_SORT_TIERS)


def test_gather_columns_kernel_matches_plain_version(card):
    """40 columns of bool, int32, float32 and int64 (two launches) and a 0-d
    count that rides along, through a random permutation; no host
    synchronisation inside the wrapper."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    rng = np.random.default_rng(2)
    n = 100_003
    order = torch.from_numpy(rng.permutation(n))
    makers = [lambda: torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                                       .astype(np.int32)),
              lambda: torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
              lambda: torch.from_numpy(rng.random(n) < 0.5),
              lambda: torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))]
    cols = {f"c{i}": makers[i % 4]() for i in range(40)}
    cols["count"] = torch.tensor(5)
    want = cso.gather_columns_plain(order, cols)
    before = dict(cso.COUNTS)
    on_card = {k: v.to(card) for k, v in cols.items()}
    order_card = order.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cso.gather_columns(order_card, on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cso.COUNTS["gather_columns"] == before["gather_columns"] + 1
    assert cso.COUNTS["seg_gather"] == before["seg_gather"] + 2
    assert got["count"] is on_card["count"]
    for k, v in want.items():
        if k != "count":
            assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


def gather_case(n, seed, local):
    """A permutation of n (random, or `local`: each element moved within a
    segment of up to 40, as the stages after sort and seed move theirs) and
    40 columns of bool, int32, float32 and int64 (two launches of 32)."""
    rng = np.random.default_rng(seed)
    if local:
        sizes = rng.integers(1, 41, n)
        heads = np.cumsum(np.r_[0, sizes])
        heads = heads[heads < n]
        order = np.concatenate([h + rng.permutation(min(k, n - h))
                                for h, k in zip(heads, sizes)])
    else:
        order = rng.permutation(n)
    makers = [lambda: torch.from_numpy(rng.random(n) < 0.5),
              lambda: torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                                       .astype(np.int32)),
              lambda: torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
              lambda: torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))]
    return torch.from_numpy(order), {f"c{i}": makers[i % 4]() for i in range(40)}


# n below, at and past the kernel's kChunk (2,048) and off its multiples,
# where the chunk shrinks to fill every SM (a multiple of 16) and where it
# does not
@pytest.mark.parametrize("n", [1, 15, 2047, 2048, 100_003, 65_536 + 5, (1 << 21) + 7])
@pytest.mark.parametrize("local", [False, True], ids=["random", "local"])
def test_gather_columns_each_chunk_matches_plain_version(card, n, local):
    """The gather kernel on mixed element sizes, past kMaxCols columns, at
    each chunk size, through a random and a local permutation, with its
    launches (two); a column that is not 16-byte aligned (a view one
    element in) taken too."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    order, cols = gather_case(n, 3, local)
    cols["odd"] = torch.arange(n + 1, dtype=torch.int32)[1:]
    want = cso.gather_columns_plain(order, cols)
    on = {k: v.to(card) for k, v in cols.items()}
    on["odd"] = torch.arange(n + 1, dtype=torch.int32, device=card)[1:]
    got, launches = cso.launch_gather(order.to(card), on)
    torch.cuda.synchronize()
    assert launches == 2
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


def test_gather_columns_refuses_another_element_size(card):
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    with pytest.raises(ValueError, match="want 1, 4 or 8 bytes"):
        cso.gather_columns(torch.arange(4, device=card),
                           {"a": torch.zeros(4, dtype=torch.int16, device=card)})


def marks_case(n, seed):
    """Columns for the stage predicates: small ranges (the predicates fire),
    int32 limits among them (the differences wrap), every svtype."""
    rng = np.random.default_rng(seed)
    lim = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 2, 2 ** 31 - 1])

    def col(lo, hi, extremes=0.02):
        v = rng.integers(lo, hi, n)
        pick = rng.random(n) < extremes
        v[pick] = rng.choice(lim, int(pick.sum()))
        return torch.from_numpy(v.astype(np.int32))
    c = {"cluster_id": col(0, 40, 0), "read_id": col(0, 6, 0.01), "pos": col(-300, 300),
         "ref_end": col(-300, 500), "qry_start": col(0, 400), "qry_end": col(0, 600),
         "strand": col(-1, 2, 0), "svtype": col(0, 7, 0)}
    c["cluster_id"] = torch.sort(c["cluster_id"]).values
    valid = torch.from_numpy(rng.random(n) < 0.9)
    return c, valid, torch.from_numpy(rng.random(n) < 0.2)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stage_marks_kernel_matches_plain_version(card, seed):
    """The seeds (binsize 100, 7 and 1), the resplit's splits (its float32
    threshold, BND, a NaN merge length) and the fold's merge flags: the
    kernel == the plain version on the CPU, one launch each."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso
    n = 20_011
    c, valid, rep = marks_case(n, seed)
    on = {k: v.to(card) for k, v in c.items()}
    for binsize in (100, 7, 1):
        want = cso.seed_marks_plain(c["svtype"], c["pos"], valid, binsize)
        got = cso.seed_marks(on["svtype"], on["pos"], valid.to(card), binsize)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), binsize
    seg = c["cluster_id"]
    svbin = (torch.div(c["pos"].abs(), 20, rounding_mode="floor") * 20).to(torch.int32)
    for lo, cml in ((50.0, 0.22), (0.0, 1e-30), (50.0, float("nan")), (1e9, 3.0)):
        f = [torch.tensor(v, dtype=torch.float32) for v in (lo, cml)]
        want = cso.resplit_marks_plain(seg, svbin, c["svtype"], *f)
        before = cso.COUNTS["seg_marks"]
        got = cso.resplit_marks(seg.to(card), svbin.to(card), on["svtype"],
                                *(x.to(card) for x in f))
        assert cso.COUNTS["seg_marks"] == before + 1
        assert torch.equal(got.cpu(), want), (lo, cml)
    s = dict(c, valid=valid)
    for t in (150, 1, 2 ** 31 - 1):
        want = cso.fold_marks_plain(s, rep, t)
        got = cso.fold_marks({k: v.to(card) for k, v in s.items()}, rep.to(card), t)
        assert torch.equal(got.cpu(), want), t


def test_cluster_sorts_run_on_every_caller(card):
    """call_task_packed, cluster_assign_packed, the engine's step and the
    call path's mesh step on CUDA tensors launch the segmented sorts (no
    lexsort of ops/segments) and give the CPU's results bit for bit."""
    from sniffles_tpu_torch.ops import cluster_sorts as cso, segments as tseg
    from sniffles_tpu_torch.ops.transfer import to_device
    from sniffles_tpu_torch.parallel import device_call as tdc
    from sniffles_tpu_torch.parallel import mesh as tmesh
    from sniffles_tpu_torch.parallel.engine import call_pipeline_step
    from sniffles_tpu_torch.sim import edge_call_batches, fuzz_call_batch
    lexsorts = []
    real_lexsort = tseg.lexsort

    def counted(keys):
        if keys[0].device.type == "cuda":
            lexsorts.append(len(keys))
        return real_lexsort(keys)
    tc.lexsort = counted
    try:
        for packed in [fuzz_call_batch(7, 4096), fuzz_call_batch(8, 32768),
                       *edge_call_batches().values()]:
            before, marks = cso.COUNTS["seg_sort"], cso.COUNTS["marks"]
            got = tc.call_task_packed(to_device(packed, card), **META)
            # sort and seed, the fold, the resplit's child ids, two for the tallies;
            # the seeds' and the fold's predicates
            assert cso.COUNTS["seg_sort"] == before + 5
            assert cso.COUNTS["marks"] == marks + 2
            assert got.cpu().tolist() == tc.call_task_packed(torch.as_tensor(packed),
                                                             **META).tolist()
            assign = np.ascontiguousarray(packed[[0, 1, 2, 8, 4, 5]])
            kw = {k: META[k] for k in ("cluster_r", "cluster_repeat_h", "cluster_repeat_h_max",
                                       "cluster_merge_bnd", "cluster_merge_len", "minsvlen",
                                       "binsize", "resplit_binsize")}
            before, marks = cso.COUNTS["seg_sort"], cso.COUNTS["marks"]
            got = tc.cluster_assign_packed(to_device(assign, card), **kw)
            assert cso.COUNTS["seg_sort"] == before + 2
            assert cso.COUNTS["marks"] == marks + 2   # the seeds, the resplit
            assert got.cpu().tolist() == tc.cluster_assign_packed(torch.as_tensor(assign),
                                                                  **kw).tolist()
        for kind in ("synthetic-1", "chain36", "all-invalid"):
            sig = engine_sig(kind)
            coverage = np.full(2_200_000, 30, dtype=np.int32)
            before = cso.COUNTS["seg_sort"]
            got = call_pipeline_step(sig, coverage, engine_params("default"), device=card)
            assert cso.COUNTS["seg_sort"] == before + 2
            want = call_pipeline_step(sig, coverage, engine_params("default"), device="cpu")
            for k, v in want.items():
                g = got[k].cpu()
                assert g.dtype == v.dtype, (kind, k)
                if v.dtype == torch.float32:
                    g, v = g.view(torch.int32), v.view(torch.int32)
                assert g.tolist() == v.tolist(), (kind, k)
        packed = fuzz_call_batch(7, 4096)
        packed = packed[:, packed[5] > 0].copy()
        packed[3] = np.arange(packed.shape[1], dtype=np.int32)
        payload = tdc.pack_mesh_payload((packed, META, [None] * packed.shape[1], None), 4)
        args = (payload["shards"], payload["offsets"], payload["window_len"],
                np.full((4, 1), tdc.MESH_HALO_BP, dtype=np.int32))
        before = cso.COUNTS["seg_sort"]
        on_card = tmesh.build_sharded_assign(["cuda:0"] * 4, **META)(*args)
        assert cso.COUNTS["seg_sort"] == before + 4 * 2   # sort and seed, fold
        assert on_card["rows"].tolist() == tmesh.build_sharded_assign(["cpu"] * 4, **META)(
            *args)["rows"].tolist()
    finally:
        tc.lexsort = real_lexsort
    assert lexsorts == []
