"""Card-only tests of the PyTorch/CUDA port: the hand-written CUDA kernel
against its plain PyTorch version and the host Myers scan, and the
combine device path on the card against the host path. They skip where
no CUDA card is visible. This file imports neither JAX nor the JAX
package, so on the card it runs without them:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("max_len,seed", [(128, 11), (1024, 12), (4096, 13)])
def test_cuda_kernel_matches_plain_version(card, max_len, seed):
    pairs = seeded_pairs(64, max_len, seed)
    tensors = [torch.from_numpy(x).to(card) for x in ted.encode_pairs(pairs, max_len)]
    launches = ted.COUNTS["launches"]
    out = ted.edit_distance_batch_device(*tensors)
    torch.cuda.synchronize()
    assert ted.COUNTS["launches"] == launches + 1
    assert torch.equal(out, ted.edit_distance_batch_plain(*tensors))
    host = np.array([edit_distance(x, y) for x, y in pairs], dtype=np.int32)
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
