"""The port's hand-written kernels against their plain versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so it runs on a machine that has
only PyTorch; there, run it without the repo's conftest (which sets up the
JAX package's CPU mesh):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, B, S, H, KVH, D, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to(device, torch.bfloat16)
        for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))


# Lengths below one 128-key tile (5, 37), multiples of 32 and ragged tails
# past a tile (100, 130, 1000); MHA and GQA groups of 4 and 2.
@pytest.mark.parametrize("S", [5, 37, 96, 100, 130, 192, 1000])
@pytest.mark.parametrize("H,KVH", [(16, 16), (32, 8), (4, 2)])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_matches_plain(causal, D, H, KVH, S):
    """bf16, B=2. Tolerance: o within 2e-2 (p is rounded to bf16 before
    p.v, as on the TPU), lse within 1e-3 (f32 statistics)."""
    q, k, v = _qkv(S + D, 2, S, H, KVH, D, _card())
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("fused", ["kv", "qkv"])
def test_flash_forward_kernel_reads_strided_kv(fused):
    """q/k/v as views into a fused projection, as the model hands them
    over: k and v from [B, S, 2, KVH, D] (GQA, ``wkv``), or all three from
    [B, S, 3, H, D] (MHA, ``wqkv``). The kernel reads them by strides."""
    dev = _card()
    B, S, H, KVH, D = 2, 130, 8, (2 if fused == "kv" else 8), 64
    gen = torch.Generator(device=dev).manual_seed(0)
    if fused == "kv":
        q, _, _ = _qkv(1, B, S, H, KVH, D, dev)
        kv = torch.randn(B, S, 2, KVH, D, device=dev, dtype=torch.bfloat16,
                         generator=gen)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        qkv = torch.randn(B, S, 3, H, D, device=dev, dtype=torch.bfloat16,
                          generator=gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = tfa.flash_attention_fwd(q, k, v, D ** -0.5, True)
    po, plse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, True)
    torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (16, 16, 64),
                                     (4, 2, 32)])
def test_flash_forward_kernel_never_reads_past_s(H, KVH, D):
    """q/k/v are [:, :S] views of [B, S + 64, heads, D] tensors whose rows
    past S hold NaN. The tensor maps bound each batch at S, so the kernel's
    o and lse stay finite and match the plain version on the views."""
    dev = _card()
    B, S = 2, 100
    full = _qkv(7, B, S + 64, H, KVH, D, dev)
    for x in full:
        x[:, S:] = float("nan")
    q, k, v = (x[:, :S] for x in full)
    for causal in (True, False):
        o, lse = tfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
        po, plse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


def test_flash_forward_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.zeros(1, 16, 2, 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention_fwd(q, q, q, 0.1, True)  # f32: no plain fallback
    q = torch.zeros(1, 16, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q, 0.1, True)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _bwd_inputs(seed, B, S, H, KVH, D, causal, dev, fused=""):
    """bf16 q/k/v/do and lse/delta from the plain forward. With
    ``fused="qkv"`` q/k/v are views of one [B, S, H + 2 KVH, D] projection;
    with ``fused="nan"`` q/k/v/do are [:, :S] views of [B, S + 64, heads,
    D] tensors whose rows past S hold NaN."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, torch.bfloat16)

    def nan_tail(heads):
        x = t((B, S + 64, heads, D))
        x[:, S:] = float("nan")
        return x[:, :S]

    if fused == "nan":
        q, k, v, do = nan_tail(H), nan_tail(KVH), nan_tail(KVH), nan_tail(H)
    else:
        if fused == "qkv":
            qkv = t((B, S, H + 2 * KVH, D))
            q, k, v = (qkv[:, :, :H], qkv[:, :, H:H + KVH],
                       qkv[:, :, H + KVH:])
        else:
            q, k, v = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D))
        do = t((B, S, H, D))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, D ** -0.5, causal)
    return q, k, v, do, lse, tfa.attention_delta(do, o)


def _check_backward(args, D, causal):
    """K2 and K3 in bf16 against the plain f32 backward on the same inputs.
    Tolerance: relative L2 2e-2 per tensor (p and ds are rounded to bf16
    before their products, as on the TPU; the plain version keeps them in
    f32)."""
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    got = tfa.flash_bwd_core(*args, scale=D ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = tfa.flash_attention_bwd_plain(*args, D ** -0.5, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= 2e-2, (name, _rel_l2(g, w))


# K1's grid: lengths below one tile (5, 37) and ragged tails past it (130,
# 1000); MHA and GQA groups of 4 and 2 (K3 spreads a group over a
# thread-block cluster); each head dim.
@pytest.mark.parametrize("S", [5, 37, 130, 1000])
@pytest.mark.parametrize("H,KVH", [(16, 16), (32, 8), (4, 2)])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(causal, D, H, KVH, S):
    _check_backward(_bwd_inputs(S + D, 2, S, H, KVH, D, causal, _card()),
                    D, causal)


@pytest.mark.parametrize("S,H,KVH,D,fused", [
    (130, 8, 2, 64, "qkv"), (192, 32, 8, 128, "qkv"),
    (100, 32, 8, 128, "nan"), (100, 16, 16, 64, "nan"),
    (100, 4, 2, 32, "nan"),
    # Groups past the portable cluster size of 8: 16/1 runs clusters of 8
    # blocks with 2 heads each, 24/2 clusters of 6 with 2 heads each.
    (300, 16, 1, 64, ""), (300, 24, 2, 128, "")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_read_views_and_wide_groups(causal, S, H,
                                                           KVH, D, fused):
    """q/k/v as views of a fused projection; q/k/v/do as views whose rows
    past S hold NaN (the tensor maps bound each batch at S, so nothing past
    S is read); GQA groups wider than one cluster."""
    _check_backward(_bwd_inputs(S + H, 2, S, H, KVH, D, causal, _card(),
                                fused), D, causal)


def test_flash_backward_dkv_is_deterministic():
    """K3 sums the GQA group over a cluster's blocks in rank order, with no
    atomics: two runs give the same bits."""
    args = _bwd_inputs(3, 2, 1000, 32, 8, 128, True, _card())
    a = tfa.flash_bwd_dkv(*args, 128 ** -0.5, True)
    b = tfa.flash_bwd_dkv(*args, 128 ** -0.5, True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_flash_attention_autograd_on_card_matches_reference():
    """The autograd path on the card (K1 forward, K2/K3 backward) against
    the plain reference attention's autograd, both in bf16. Tolerance:
    relative L2 2e-2 per gradient."""
    from ray_tpu_torch.ops.attention import reference_attention

    dev = _card()
    q, k, v = (x.requires_grad_(True)
               for x in _qkv(5, 2, 200, 8, 2, 64, dev))
    do = torch.randn(2, 200, 8, 64, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(1))
    counts = (tfa.flash_attention_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    got = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    want = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), do)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 2e-2


def test_flash_backward_kernels_refuse_what_they_do_not_take():
    dev = _card()
    q = torch.zeros(1, 16, 2, 64, device=dev)
    lse = torch.zeros(1, 2, 16, 1, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse, 0.1, True)
    qb = q.bfloat16()
    with pytest.raises(TypeError, match="float32"):
        tfa.flash_bwd_dkv(qb, qb, qb, qb, lse.bfloat16(), lse, 0.1, True)


def test_device_batch_stream_pinned_ring_is_exact_and_never_overwritten():
    """``device_batch_stream``'s ring of pinned buffers (2 batches ahead,
    3 buffers): every batch reaches the card bit for bit and in order,
    also while the consumer holds the batches it was given, runs work on
    them on its own stream, and is slow enough that the producer waits on
    the ring; a batch of another shape reallocates its buffer."""
    from ray_tpu_torch.data.iterator import device_batch_stream

    dev = _card()
    rng = np.random.default_rng(9)
    batches = [{"x": rng.standard_normal((64, 197, 33)).astype(np.float32),
                "id": np.arange(i * 64, (i + 1) * 64)} for i in range(12)]
    batches.append({"x": rng.standard_normal((5, 3)).astype(np.float32),
                    "id": np.arange(5)})
    held = []
    for i, got in enumerate(device_batch_stream(iter(batches), dev, 2)):
        assert got["x"].device.type == "cuda"
        # Work queued on the consumer's stream behind the copy's event.
        held.append({k: v * 1 for k, v in got.items()})
        torch.cuda._sleep(20_000_000)  # the producer runs ahead meanwhile
    torch.cuda.synchronize()
    assert len(held) == len(batches)
    for got, want in zip(held, batches):
        np.testing.assert_array_equal(got["x"].cpu().numpy(), want["x"])
        np.testing.assert_array_equal(got["id"].cpu().numpy(), want["id"])


def test_device_batch_stream_stops_when_dropped():
    """A consumer that leaves early stops the producer thread."""
    import threading

    from ray_tpu_torch.data.iterator import device_batch_stream

    dev = _card()

    def endless():
        while True:
            yield {"x": np.ones((8, 8), np.float32)}

    stream = device_batch_stream(endless(), dev, 2)
    next(stream)
    stream.close()
    assert not any(t.name == "device-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_cuda_tensor_travels_as_host_copy():
    """The core's serialization (``core/serialization.py``): a CUDA tensor
    pickles as its host copy (no card in the bytes) and comes back on the
    receiving process's own card, here the current one, bit for bit."""
    import pickle

    from ray_tpu_torch.core import serialization as ser

    dev = _card()
    t = torch.randn(4, 8, device=dev).to(torch.bfloat16)
    data = ser.dumps({"x": t, "f": t.float()})
    assert b"cuda" not in data
    back = pickle.loads(data)
    assert back["x"].device == torch.device("cuda",
                                            torch.cuda.current_device())
    assert torch.equal(back["x"], t) and torch.equal(back["f"], t.float())
