"""The flash attention kernel's plain version against the reference's Pallas
kernel (``repro.kernels.flash_attention``, run in interpret mode on the
CPU), on the same inputs made with numpy: the reference's own sweep
(``tests/test_kernels.py::ATTN_CASES``) in float32 and bfloat16 at its
tolerances (2e-6 / 2e-2), a gemma3-1b head shape, a query block past the
keys (fully masked rows give 0), and the shape contract; and the strides
the kernels take (``byte_strides``), with the plain version on strided
views."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import blockwise_attention as ref_blockwise
from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention import (byte_strides,
                                                 flash_attention,
                                                 flash_attention_plain)

pytestmark = pytest.mark.tier1

ATTN_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, softcap
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 8, 1, 256, 256, 64, True, 64, None),      # GQA 8:1 + window
    (2, 2, 2, 128, 256, 128, True, None, 30.0),   # softcap + longer kv
    (1, 4, 4, 1, 384, 64, True, None, None),      # decode-style q
    (1, 2, 1, 128, 128, 32, False, None, None),   # non-causal (cross-attn)
]
# The reference sweep's tolerances (tests/test_kernels.py).
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, hq, sq, d), rng.randn(b, hkv, skv, d),
            rng.randn(b, hkv, skv, d)]
    ref = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    # the same (rounded) values on both sides
    port = [torch.from_numpy(np.array(r.astype(jnp.float32))).to(
        TORCH[dtype]) for r in ref]
    return ref, port


def _compare(case, dtype, seed=0, **kw):
    b, hq, hkv, sq, skv, d, causal, window, cap = case
    (q, k, v), (tq, tk, tv) = _inputs(seed, b, hq, hkv, sq, skv, d, dtype)
    want = ref_flash(q, k, v, causal=causal, window=window,
                     logit_softcap=cap, interpret=True, **kw)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          logit_softcap=cap, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    return got


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(case, dtype):
    cuda.reset_counts()
    _compare(case, dtype)
    assert cuda.PLAIN_CALLS["flash_attention"] == 1
    assert cuda.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_head_shape(dtype):
    """gemma3-1b's heads (Hq=4, Hkv=1, D=256) on a local layer's window."""
    _compare((1, 4, 1, 256, 256, 256, True, 64, None), dtype, seed=1)


def test_scale_and_tiles_pass_through():
    _compare((1, 2, 1, 64, 192, 16, True, 40, 20.0), "float32", seed=2,
             scale=0.3, bq=32, bk=64)


def test_rows_past_the_keys_give_zero():
    """Sq > Skv: the first Sq - Skv queries sit before every key, so
    causal masking leaves them no key and both kernels write 0."""
    got = _compare((1, 2, 1, 256, 128, 32, True, None, None), "float32",
                   seed=3)
    assert float(got[:, :, :128].abs().max()) == 0.0
    assert float(got[:, :, 128:].abs().min()) > 0.0


def test_shape_contract_raises_in_both():
    """The reference kernel asserts on Sq = 200 (not a multiple of its
    128-row tile); the port takes it with a ragged last tile (the next
    test holds the result), and both refuse a bad head count or type."""
    (q, k, v), (tq, tk, tv) = _inputs(4, 1, 2, 1, 200, 256, 32, "float32")
    with pytest.raises(AssertionError):
        ref_flash(q, k, v, interpret=True)
    assert flash_attention(tq, tk, tv).shape == (1, 2, 200, 32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(tq[:, :1, :128].expand(1, 3, 128, 32),
                        tk.expand(1, 2, 256, 32), tv.expand(1, 2, 256, 32))
    with pytest.raises(TypeError):
        flash_attention(tq[:, :, :128].half(), tk.half(), tv.half())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 77, 200, 300])
@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                               (True, 64, None),
                                               (True, None, 30.0),
                                               (False, None, None)])
def test_ragged_lengths_match_blockwise_reference(s, causal, window, cap,
                                                  dtype):
    """Lengths that are no multiple of the 128-row tiles: the plain version
    (ragged last q and kv tiles) against the reference's
    ``blockwise_attention``, which the reference's dispatcher takes for
    them off the TPU."""
    (q, k, v), (tq, tk, tv) = _inputs(6, 1, 4, 2, s, s, 64, dtype)
    want = ref_blockwise(q, k, v, causal=causal, window=window,
                         logit_softcap=cap)
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          logit_softcap=cap)
    assert got.dtype == TORCH[dtype] and got.shape == (1, 4, s, 64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_is_the_online_softmax_of_full_attention():
    """Independent of the reference: the plain version equals a direct
    softmax over the masked scores (window, soft-cap, GQA)."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, 4, 128, 32))
    k = torch.from_numpy(rng.randn(1, 2, 384, 32))
    v = torch.from_numpy(rng.randn(1, 2, 384, 32))
    got = flash_attention_plain(q.float(), k.float(), v.float(), window=100,
                                logit_softcap=15.0, bk=64)
    kk = k.repeat_interleave(2, dim=1)
    vv = v.repeat_interleave(2, dim=1)
    s = q @ kk.transpose(-1, -2) * 32 ** -0.5
    s = 15.0 * torch.tanh(s / 15.0)
    qpos = torch.arange(256, 384)[:, None]
    kpos = torch.arange(384)[None, :]
    s = s.masked_fill(~((kpos <= qpos) & (kpos > qpos - 100)), -torch.inf)
    want = torch.softmax(s, dim=-1) @ vv
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), atol=2e-6,
                               rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["contiguous", "transposed", "packed_kv",
                                  "one_row"])
def test_byte_strides_of_the_views_the_kernels_take(view, dtype):
    """(batch, head, row) strides in bytes: the tensor's own where a
    dimension is stepped, the contiguous stride where it has size 1."""
    item = torch.empty((), dtype=dtype).element_size()
    b, h, s, d = 2, 3, 8, 32
    if view == "contiguous":
        x, want = torch.zeros(b, h, s, d, dtype=dtype), (h * s * d, s * d, d)
    elif view == "transposed":                 # [B, S, H, D] seen as BHSD
        x = torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)
        want = (s * h * d, d, h * d)
    elif view == "packed_kv":                  # k of a [B, S, 2, H, D] pack
        x = torch.zeros(b, s, 2, h, d, dtype=dtype)[:, :, 1].transpose(1, 2)
        want = (s * 2 * h * d, d, 2 * h * d)
    else:                                      # B = 1 and one row: size-1
        x = torch.zeros(1, s, h, d, dtype=dtype).transpose(1, 2)[:, :, 3:4]
        want = (h * d, d, d)                   # dims take dense strides
    got = byte_strides(x)
    assert got == tuple(w * item for w in want)
    assert all(g % 16 == 0 for g in got)


@pytest.mark.parametrize("bad,match", [
    ("last_dim", "last dimension"),
    ("odd_row", "multiples of 16"),
    ("misaligned", "16-byte aligned"),
    ("broadcast", "multiples of 16"),
    ("three_dims", "4-D"),
])
def test_byte_strides_raises_on_views_the_kernels_cannot_read(bad, match):
    x = torch.zeros(2, 2, 8, 40, dtype=torch.bfloat16)
    t = {"last_dim": x[..., :16].transpose(2, 3),
         # rows of 36 bfloat16 values: 72 bytes apart
         "odd_row": torch.zeros(2, 2, 8, 36, dtype=torch.bfloat16)[..., :32],
         "misaligned": x.reshape(-1)[1:1 + 2 * 2 * 8 * 16].view(2, 2, 8, 16),
         "broadcast": x[:, :1].expand(2, 2, 8, 40),
         "three_dims": x[0]}[bad]
    with pytest.raises(ValueError, match=match):
        byte_strides(t)


@pytest.mark.parametrize("window,cap", [(None, None), (48, None),
                                        (None, 20.0)])
def test_plain_on_strided_views_equals_contiguous(window, cap):
    """The plain version reads [B, S, H, D] tensors seen as [B, H, S, D]
    (q) and slices of one packed kv tensor (k, v) exactly as it reads
    their contiguous copies."""
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(2, 128, 4, 32)).float().transpose(1, 2)
    kv = torch.from_numpy(rng.randn(2, 128, 2, 2, 32)).float()
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous())
    got = flash_attention(q, k, v, window=window, logit_softcap=cap)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=window, logit_softcap=cap)
    assert got.is_contiguous()
    assert torch.equal(got, want)
