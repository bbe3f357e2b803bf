"""The port's batched edit distance (sniffles_tpu_torch/ops/edit_distance_batch.py)
against the JAX package's: encode_pairs byte for byte, the plain PyTorch
bit-vector version against edit_distance_batch_jnp (the CPU form of the
Pallas kernel) and against the host Myers scan, on random pairs, word
boundaries, alphabets beyond ACGT, mixed lengths and padding. Every
output is an integer, so every comparison is exact. The CUDA kernel
itself runs only on the card (tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sniffles_tpu.ops import edit_distance_jax as jed  # noqa: E402
from sniffles_tpu_torch.ops import edit_distance_batch as ted  # noqa: E402
from sniffles_tpu_torch.ops.edit_distance import edit_distance  # noqa: E402


def seeded_pairs(n, max_len, seed):
    """Random pairs plus near-copies (substitutions and indels), with
    empty strings and length max_len - 1 among them."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    out = []
    for k in range(n):
        la = int(rng.integers(0, max_len))
        a = "".join(rng.choice(bases, la))
        if k % 2 and la:
            b = list(a)
            for _ in range(int(rng.integers(0, 6))):
                p = int(rng.integers(0, max(1, len(b))))
                op = int(rng.integers(0, 3))
                if op == 0 and b:
                    b[p] = str(rng.choice(bases))
                elif op == 1 and len(b) < max_len - 1:
                    b.insert(p, str(rng.choice(bases)))
                elif len(b) > 1:
                    del b[p]
            b = "".join(b)
        else:
            b = "".join(rng.choice(bases, int(rng.integers(0, max_len))))
        out.append((a, b))
    top = max_len - 1
    out += [("", ""), ("A", ""), ("", "ACGT"), ("ACGT", "ACGT"),
            ("AAAA", "TTTT"), ("A" * top, ""), ("", "C" * top),
            ("A" * top, "A" * top), ("A" * top, "T" * top),
            ("A" * top, "A" * (top - 1) + "T")]
    return out


# lengths around the 32-bit words of the bit-vector scan
WORD_BOUNDS = (0, 1, 31, 32, 33, 63, 64, 65, 1023, 1024, 4095)


def mutated(rng, s: bytes, alphabet: bytes, length: int, edits: int) -> bytes:
    """s cut or extended to `length` from `alphabet`, then `edits`
    substitutions: a related string of another length."""
    t = bytearray(s[:length])
    t += bytes(rng.choice(list(alphabet), max(0, length - len(s))).tolist())
    for _ in range(edits):
        if t:
            t[int(rng.integers(0, len(t)))] = int(rng.choice(list(alphabet)))
    return bytes(t)


def byte_pairs(kind, max_len, seed):
    """Pairs of byte strings of one kind, all of length <= max_len - 1."""
    rng = np.random.default_rng(seed)

    def rand(alphabet, n):
        return bytes(rng.choice(list(alphabet), n).tolist())

    if kind == "word_bounds":
        out = []
        for x in WORD_BOUNDS:
            for y in WORD_BOUNDS:
                a = rand(b"ACGT", x)
                out.append((a, mutated(rng, a, b"ACGT", y, 3)))
        return out
    if kind == "alphabets":
        # DNA with lowercase, N and IUPAC codes (more than 8 distinct
        # bytes), and arbitrary bytes 0..255 against them
        iupac = b"ACGTNacgtnRYKMSWBDHV"
        out = []
        for x, y in ((200, 190), (33, 64), (64, 33), (1, 200), (0, 5), (150, 150)):
            a = rand(iupac, x)
            out += [(a, mutated(rng, a, iupac, y, 4)), (a, rand(b"ACGT", y)),
                    (rand(bytes(range(256)), x), rand(bytes(range(256)), y)),
                    (a, rand(b"xyz", y))]
        return out + [(b"\x00" * 40, b"\x00" * 39 + b"A"), (b"\xff\x00A", b"A\x00\xff")]
    if kind == "mixed_lengths":
        # 60 bp against long alleles, in one batch: the skew and the masks
        # of the last word differ pair by pair
        long = max_len - 1
        out = []
        for x, y in ((60, long), (long, 60), (60, 60), (long, long), (0, long),
                     (long, 0), (61, 1000), (1000, 61), (5, 3)):
            a = rand(b"ACGT", x)
            out.append((a, mutated(rng, a, b"ACGT", y, 8)))
        return out
    if kind == "padding":
        return [(b"", b"")] * 16
    if kind == "empty_sides":
        return [(b"", b""), (b"A", b""), (b"", b"C"), (rand(b"ACGT", 100), b""),
                (b"", rand(b"ACGT", 127)), (b"", b""), (rand(b"ACGT", 40), b"")]
    raise ValueError(kind)


def encode_bytes(pairs, L):
    """encode_pairs for byte strings of any values (it takes ASCII text)."""
    B = len(pairs)
    a = np.zeros((B, L), dtype=np.uint8)
    b = np.zeros((B, L), dtype=np.uint8)
    la = np.array([len(x) for x, _ in pairs], dtype=np.int32)
    lb = np.array([len(y) for _, y in pairs], dtype=np.int32)
    for i, (x, y) in enumerate(pairs):
        a[i, :len(x)] = np.frombuffer(x, dtype=np.uint8)
        b[i, :len(y)] = np.frombuffer(y, dtype=np.uint8)
    return a, b, la, lb


def run_plain(a, b, la, lb):
    return ted.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, la, lb))).numpy()


@pytest.mark.parametrize("max_len,seed", [(128, 1), (256, 2)])
def test_encode_pairs_matches_jax(max_len, seed):
    pairs = seeded_pairs(40, max_len, seed)
    for fixed in (None, max_len):
        ours = ted.encode_pairs(pairs, fixed)
        theirs = jed.encode_pairs(pairs, fixed)
        for x, y in zip(ours, theirs):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
    # the [:max_len] truncation
    long = [("A" * 300, "C" * 10)]
    for x, y in zip(ted.encode_pairs(long, 128), jed.encode_pairs(long, 128)):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("max_len,seed,kind", [
    pytest.param(128, 3, "random", id="128-3"),
    pytest.param(256, 4, "random", id="256-4"),
    pytest.param(4096, 5, "word_bounds", id="word_bounds"),
    pytest.param(256, 6, "alphabets", id="alphabets"),
    pytest.param(1152, 7, "mixed_lengths", id="mixed_lengths"),
    pytest.param(128, 8, "padding", id="padding"),
    pytest.param(128, 9, "empty_sides", id="empty_sides"),
])
def test_plain_matches_jnp_and_host(max_len, seed, kind):
    if kind == "random":
        pairs = [(x.encode(), y.encode()) for x, y in seeded_pairs(48, max_len, seed)]
    else:
        pairs = byte_pairs(kind, max_len, seed)
    a, b, la, lb = encode_bytes(pairs, max_len)
    ours = run_plain(a, b, la, lb)
    theirs = np.asarray(jed.edit_distance_batch_jnp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)))
    host = np.array([edit_distance(x.decode("latin-1"), y.decode("latin-1"))
                     for x, y in pairs], dtype=np.int32)
    assert ours.dtype == np.int32
    assert (ours == theirs).all()
    assert (ours == host).all()


def test_wrapper_on_cpu_takes_plain_version():
    pairs = seeded_pairs(20, 128, 5)
    tensors = [torch.from_numpy(x) for x in ted.encode_pairs(pairs, 128)]
    before = dict(ted.COUNTS)
    out = ted.edit_distance_batch_device(*tensors)
    assert (out.numpy() == run_plain(*(t.numpy() for t in tensors))).all()
    assert ted.COUNTS == before  # no kernel launch on the CPU


def test_wrapper_checks_inputs():
    a, b, la, lb = (torch.from_numpy(x) for x in ted.encode_pairs([("AC", "A")], 128))
    with pytest.raises(TypeError):
        ted.edit_distance_batch_device(a.to(torch.int32), b, la, lb)
    with pytest.raises(TypeError):
        ted.edit_distance_batch_device(a, b, la.to(torch.int64), lb)
    with pytest.raises(ValueError):
        ted.edit_distance_batch_device(a, b[:, :64].contiguous(), la, lb)
    with pytest.raises(ValueError):
        ted.edit_distance_batch_device(a[:, ::2], b[:, ::2], la, lb)


def test_dispatcher_routes_and_counts(monkeypatch):
    """Below DEVICE_MIN_CELLS the host Myers scan; above it the device
    route (its plain version on the CPU), padded to a power of two. Both
    equal the JAX dispatcher's answers."""
    pairs = seeded_pairs(30, 128, 6)
    counters = {}
    host = ted.edit_distance_batch(pairs, device="cpu", counters=counters)
    assert counters == {"ed_host_batches": 1, "ed_host_pairs": len(pairs)}
    monkeypatch.setattr(ted, "DEVICE_MIN_CELLS", 1)
    counters = {}
    dev = ted.edit_distance_batch(pairs, device="cpu", counters=counters)
    assert counters["ed_device_batches"] == 1
    assert counters["ed_device_pairs"] == len(pairs)
    theirs = jed.edit_distance_batch(pairs)
    assert (host == theirs).all() and (dev == theirs).all()
    with pytest.raises(ValueError):
        ted.edit_distance_batch(pairs)  # a device batch needs a device


def test_build_distance_cache_matches_jax():
    rng = np.random.default_rng(8)
    alts = ["".join(rng.choice(list("ACGT"), int(rng.integers(1, 90))))
            for _ in range(9)]
    ours = ted.build_distance_cache(alts[:4], alts[3:], device="cpu")
    theirs = jed.build_distance_cache(alts[:4], alts[3:])
    assert ours == theirs
