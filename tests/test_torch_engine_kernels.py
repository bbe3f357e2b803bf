"""The host side of the fused engine's two kernels and their tools, on the
CPU (the kernels themselves run only on the card: tests/test_torch_gpu.py,
chip_smoke.py phase 10):

  * sim.relax_chain_batch, the tiled 36-link chain the relaxation is timed
    on: its copies never merge, so two copies take the chain's 32 capped
    rounds, and the port's relaxation gives the JAX package's clusters on
    it (cluster_signatures with exact_sweep=False, jitted; tolerance 0);
  * the relaxation wrapper's column and stamp checks (ops/merge_relax.py,
    relax_columns) and the round split of tools/time_merge_relax.py;
  * tools/profile_engine.py's stages (the step's spans) on the CPU, and
    the cluster ids its --tail-split takes from the step;
  * --dev-debug PORT with nothing listening: the JAX package's warning in
    the log, exit 0, and the records of a run without the flag.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import clustering as jcl  # noqa: E402
from sniffles_tpu_torch.ops import clustering as tcl  # noqa: E402
from sniffles_tpu_torch.ops import merge_relax as tmr  # noqa: E402
from sniffles_tpu_torch.sim import relax_chain_batch, relax_chain_positions  # noqa: E402
from sniffles_tpu_torch.tools import profile_engine, time_merge_relax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
               cluster_merge_bnd=1000, cluster_merge_len=0.22, minsvlen=50)
RELAX = dict(cluster_r=2.5, cluster_repeat_h=1.5, cluster_repeat_h_max=1000.0,
             cluster_merge_bnd=1000, global_repeat=False, binsize=100)
CHAIN = len(relax_chain_positions(36))


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("SNIFFLES_TPU_FORCE_CPU", "1")


def sorted_seeds(sig):
    return tcl.sort_and_seed({k: torch.as_tensor(v) for k, v in sig.items()}, 100)


# -- the tiled chain ----------------------------------------------------------

@pytest.mark.parametrize("size", [CHAIN - 1, CHAIN, 2 * CHAIN + 500])
def test_relax_chain_batch_holds_whole_copies(size):
    sig = relax_chain_batch(size)
    copies = size // CHAIN
    assert sig["pos"].shape == (size,) and sig["pos"].dtype == np.int32
    assert int(sig["valid"].sum()) == copies * CHAIN
    chain = np.asarray(relax_chain_positions(36))
    for c in range(copies):
        got = sig["pos"][c * CHAIN:(c + 1) * CHAIN]
        assert np.array_equal(got, chain + c * 1_100_000)
    assert not sig["valid"][copies * CHAIN:].any()
    assert np.array_equal(sig["read_id"][:copies * CHAIN], np.arange(copies * CHAIN))


def test_relax_chain_batch_refuses_copies_that_would_merge():
    with pytest.raises(ValueError, match="merge"):
        relax_chain_batch(2 * CHAIN, spacing=700_000)
    with pytest.raises(ValueError, match="overflow"):
        relax_chain_batch(3 * CHAIN, spacing=1_500_000_000)


def test_two_tiled_chains_take_the_capped_rounds_of_one():
    """Each copy relaxes as the chain alone: 32 rounds, and the second
    copy's boundaries are the first's shifted by one chain."""
    one, rounds_one = tmr.merge_relax(*sorted_seeds(relax_chain_batch(CHAIN)), **RELAX)
    two, rounds_two = tmr.merge_relax(*sorted_seeds(relax_chain_batch(2 * CHAIN)), **RELAX)
    assert rounds_one == rounds_two == tmr.MERGE_ITERS_MAX
    assert two[:CHAIN].tolist() == one.tolist()
    assert two[CHAIN:].tolist() == one.tolist()


def test_tiled_chain_relaxation_matches_jax():
    sig = relax_chain_batch(2 * CHAIN + 500)
    theirs = jcl.cluster_signatures({k: jnp.asarray(v) for k, v in sig.items()},
                                    exact_sweep=False, **CLUSTER)
    ours = tcl.cluster_signatures({k: torch.from_numpy(v) for k, v in sig.items()},
                                  exact_sweep=False, **CLUSTER)
    assert ours["merge_rounds"] == tmr.MERGE_ITERS_MAX
    for k, v in theirs.items():
        if k != "merge_rounds":
            assert ours[k].numpy().tolist() == np.asarray(v).tolist(), k


# -- the relaxation wrapper's checks and the timing tool ----------------------

def test_relax_columns_gives_the_kernels_types():
    s, boundary, bin_ = sorted_seeds(relax_chain_batch(CHAIN))
    cols = tmr.relax_columns(s, boundary, bin_)
    assert {k: v.dtype for k, v in cols.items()} == {
        "pos": torch.int32, "svlen": torch.int32, "svtype": torch.int32,
        "bin": torch.int32, "repeat": torch.uint8, "valid": torch.uint8}
    assert cols["valid"].tolist() == s["valid"].to(torch.uint8).tolist()
    assert all(v.is_contiguous() and v.shape == boundary.shape for v in cols.values())
    stamps = torch.zeros(tmr.STAMP_WORDS, dtype=torch.int64)
    assert set(tmr.relax_columns(s, boundary, bin_, stamps)) == set(cols)


def test_relax_columns_start_on_16_bytes():
    """A column that is a view starting mid-allocation is copied; the
    kernel reads bins 16 bytes at a time."""
    s, boundary, bin_ = sorted_seeds(relax_chain_batch(CHAIN + 1))
    s = {k: v[1:] for k, v in s.items()}
    boundary, bin_ = boundary[1:], bin_[1:]
    assert bin_.data_ptr() % 16 != 0
    cols = tmr.relax_columns(s, boundary, bin_)
    assert all(v.data_ptr() % 16 == 0 for v in cols.values())
    assert cols["bin"].tolist() == bin_.tolist()
    assert cols["pos"].tolist() == s["pos"].tolist()


@pytest.mark.parametrize("fault", ["short column", "2-d boundaries", "empty", "stamps dtype",
                                   "stamps length"])
def test_relax_columns_refuses_what_the_kernel_does_not_take(fault):
    s, boundary, bin_ = sorted_seeds(relax_chain_batch(CHAIN))
    stamps = None
    if fault == "short column":
        s = dict(s, svlen=s["svlen"][:-1])
    elif fault == "2-d boundaries":
        boundary = boundary[None, :]
    elif fault == "empty":
        s, boundary, bin_ = {k: v[:0] for k, v in s.items()}, boundary[:0], bin_[:0]
    elif fault == "stamps dtype":
        stamps = torch.zeros(tmr.STAMP_WORDS, dtype=torch.int32)
    else:
        stamps = torch.zeros(tmr.STAMP_WORDS - 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="merge_relax"):
        tmr.relax_columns(s, boundary, bin_, stamps)


def test_rounds_from_stamps_splits_each_round():
    stamps = [1_000, 3_000] + [3_000 + 500 * k for k in range(1, 2 * tmr.MERGE_ITERS_MAX + 1)]
    setup, split = time_merge_relax.rounds_from_stamps(stamps, 2)
    assert setup == 0.002
    assert split == [(0.0005, 0.0005), (0.0005, 0.0005)]


def test_rounds_from_kernels_pairs_each_rounds_two_kernels():
    kernels = [("(anonymous namespace)::relax_metrics(float const*)", 0.0, 10.0),
               ("(anonymous namespace)::relax_merge(int const*)", 11.0, 14.0),
               ("void at::native::fill", 14.0, 14.5),
               ("(anonymous namespace)::relax_metrics(float const*)", 16.0, 17.0),
               ("(anonymous namespace)::relax_merge(int const*)", 17.5, 18.0)]
    assert time_merge_relax.rounds_from_kernels(kernels) == [
        (0.01, 0.003, 0.002), (0.001, 0.0005, 0.0)]


# -- the engine's profile -----------------------------------------------------

def test_profile_engine_wraps_every_stage_once_a_step():
    """The tool's stages are the step's own spans, each once a step (the
    eager body's), and it wraps no module function; on the CPU it times
    no turn."""
    from sniffles_tpu_torch.ops import clustering, merge_relax
    from sniffles_tpu_torch.parallel import engine
    from sniffles_tpu_torch.spans import STAGES, STEP
    mods = (clustering, merge_relax, engine)
    before = [dict(vars(mod)) for mod in mods]
    fig = profile_engine.profile(4096, 2, "cpu")
    assert {label for label in fig["split"] if label is not None} == {*STAGES, STEP}
    assert all(v[3] == 1 for label, v in fig["split"].items() if label is not None)
    assert fig["turns"] is None and "step_ms" not in fig and "interval_ms" not in fig
    assert not hasattr(profile_engine, "stage_targets")
    assert all(vars(mod) == b for mod, b in zip(mods, before))


def test_tail_split_takes_the_ids_the_step_hands_its_tail():
    """--tail-split's layouts are the cluster ids of the step's own
    clustering (cluster_signatures at the step's parameters), ascending,
    and the engine's module is restored afterwards; on the CPU it times
    nothing."""
    from sniffles_tpu_torch.ops import candidate_tail as ct
    from sniffles_tpu_torch.parallel import engine
    tail = engine.candidate_tail
    sig, coverage, params = profile_engine.engine_inputs(4096, "cpu")
    cid = profile_engine.tail_ids(sig, coverage, params)
    assert engine.candidate_tail is tail
    want = tcl.cluster_signatures(
        sig, minsvlen=params["minsvlen"], cluster_merge_len=params["cluster_merge_len"],
        exact_sweep=False, **{k: params[k] for k in ("cluster_r", "cluster_repeat_h",
                                                   "cluster_repeat_h_max", "cluster_merge_bnd")}
    )["cluster_id"]
    assert cid.dtype == torch.int32 and torch.equal(cid, want.to(torch.int32))
    assert bool((cid[1:] >= cid[:-1]).all())
    assert ct.tail_runs_plain(cid).shape[0] == int(cid[-1]) + 2


# -- --dev-debug PORT -----------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def test_dev_debug_without_a_listener_warns_and_changes_no_record(tmp_path):
    from sniffles_tpu_torch.sim import PlantedSV, write_dataset
    bam, _ = write_dataset(str(tmp_path), ref_len=60_000, depth=10, seed=11,
                           svs=[PlantedSV(20_000, "DEL", 120), PlantedSV(40_000, "INS", 150)])
    env = dict(os.environ, SNIFFLES_TPU_FORCE_CPU="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    runs = {}
    for label, extra in (("plain", []), ("debug", ["--dev-debug", str(free_port())])):
        vcf = str(tmp_path / f"{label}.vcf")
        proc = subprocess.run([sys.executable, "-m", "sniffles_tpu_torch", "--input", bam,
                               "--vcf", vcf, "--threads", "0", *extra], env=env,
                              capture_output=True, text=True, timeout=300)
        runs[label] = (proc, records(vcf) if proc.returncode == 0 else None)
    for label, (proc, _) in runs.items():
        assert proc.returncode == 0, (label, proc.stderr[-2000:])
    log = runs["debug"][0].stdout + runs["debug"][0].stderr
    assert "could not attach a remote debugger" in log
    assert "could not attach a remote debugger" not in (runs["plain"][0].stdout
                                                        + runs["plain"][0].stderr)
    assert runs["debug"][1] == runs["plain"][1] and len(runs["plain"][1]) == 2
