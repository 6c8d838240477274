"""The CUDA kernels of repro_torch against their plain PyTorch versions.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. The file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.optimizers import prox_adam
from repro_torch.kernels.bsr_spmm import ops, ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.sparse.compress import CompressionPlan, _pad_stack, quantize_bcsr
from repro_torch.sparse.formats import dense_to_bcsr

# f32 accumulation of the same products in another order
ATOL, RTOL = 2e-4, 1e-4
KERNEL_SHAPES = [(960, 960, (8, 128)), (2560, 960, (8, 128)),
                 (960, 2560, (8, 128)), (64, 128, (8, 64)),
                 (96, 160, (32, 32)), (128, 64, (16, 16)), (100, 70, (8, 64))]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block_sparse(rng, n, k, block, density):
    """(n, k) f32 with each (br, bc) block (ragged at the edges) nonzero
    with probability ``density``."""
    br, bc = block
    keep = rng.random((-(-n // br), -(-k // bc))) < density
    mask = np.kron(keep, np.ones(block, bool))[:n, :k]
    return (rng.normal(size=(n, k)) * mask).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("m", [1, 4, 33, 256, 512])
def test_cuda_spmm_matches_plain(n, k, block, density, m):
    dev = _cuda()
    rng = np.random.default_rng(11)
    w = dense_to_bcsr(_block_sparse(rng, n, k, block, density), block).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.normal(size=(m, k)), dtype=dtype, device=dev)
        before = ops.launches["spmm"]
        got = ops.spmm(x, w)
        assert ops.launches["spmm"] == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.spmm_fwd_ref(x, w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [4, 256, 512])
def test_cuda_spmm_palette_matches_plain(n, k, block, bits, m):
    dev = _cuda()
    rng = np.random.default_rng(12)
    q = quantize_bcsr(dense_to_bcsr(_block_sparse(rng, n, k, block, 0.2),
                                    block).to(dev), bits)
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.bfloat16, device=dev)
    before = ops.launches["spmm_palette"]
    got = ops.spmm_palette(x, q)
    assert ops.launches["spmm_palette"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.spmm_palette_fwd_ref(x, q), atol=ATOL,
                               rtol=RTOL)


# recurrentgemma-9b's width: a 4096 x 4096 projection on (8, 128) blocks
RG_SHAPE = (4096, 4096, (8, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_cuda_spmm_recurrentgemma_width(m, x_dtype, store):
    dev = _cuda()
    n, k, block = RG_SHAPE
    rng = np.random.default_rng(14)
    w = dense_to_bcsr(_block_sparse(rng, n, k, block, 0.1) / np.sqrt(k),
                      block).to(dev)
    w = dataclasses.replace(w, data=w.data.to(store))
    x = torch.tensor(rng.normal(size=(m, k)), dtype=x_dtype, device=dev)
    got = ops.spmm(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.spmm_fwd_ref(x, w), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 17, 256])
@pytest.mark.parametrize("kernel", ["decode", "tile"])
@pytest.mark.parametrize("wrapper", ["spmm", "spmm_palette"])
def test_cuda_spmm_variants_match_plain_and_count(m, kernel, wrapper):
    """Both forward kernels at both sides of the M threshold, each held to
    the plain version; the wrapper's count and the variant's count rise by
    one, the other variant's not at all; the wrapper itself takes the
    decode kernel up to ``DECODE_MAX_M`` rows, the tile above."""
    dev = _cuda()
    rng = np.random.default_rng(15)
    w = dense_to_bcsr(_block_sparse(rng, 256, 960, (8, 128), 0.3),
                      (8, 128)).to(dev)
    plain = ref.spmm_fwd_ref
    if wrapper == "spmm_palette":
        w, plain = quantize_bcsr(w, 8), ref.spmm_palette_fwd_ref
    x = torch.tensor(rng.normal(size=(m, 960)), dtype=torch.bfloat16, device=dev)
    other = "tile" if kernel == "decode" else "decode"
    for forced in (kernel, None):
        use = kernel if forced else ("decode" if m <= ops.DECODE_MAX_M else "tile")
        before = dict(ops.variant_launches)
        total = ops.launches[wrapper]
        got = (ops._fwd(x, w, forced) if forced
               else getattr(ops, wrapper)(x, w))
        torch.cuda.synchronize()
        assert ops.launches[wrapper] == total + 1
        assert ops.variant_launches[f"{wrapper}_{use}"] == \
            before[f"{wrapper}_{use}"] + 1
        unused = other if forced else ("tile" if use == "decode" else "decode")
        assert ops.variant_launches[f"{wrapper}_{unused}"] == \
            before[f"{wrapper}_{unused}"]
        torch.testing.assert_close(got, plain(x, w), atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 128])
def test_cuda_spmm_takes_non_contiguous_input(m):
    dev = _cuda()
    rng = np.random.default_rng(13)
    w = dense_to_bcsr(_block_sparse(rng, 64, 128, (8, 128), 0.5), (8, 128)).to(dev)
    x = torch.tensor(rng.normal(size=(128, m)), dtype=torch.float32, device=dev).T
    assert not x.is_contiguous()
    torch.testing.assert_close(ops.spmm(x, w), ref.spmm_fwd_ref(x, w),
                               atol=ATOL, rtol=RTOL)
    # a contiguous x that starts off a 16-byte boundary: plain-load staging
    for dt in (torch.float32, torch.bfloat16):
        xo = _off_boundary(x.to(dt))
        torch.testing.assert_close(ops.spmm(xo, w), ref.spmm_fwd_ref(xo, w),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernel_does_not_take():
    dev = _cuda()
    w = dense_to_bcsr(np.ones((64, 128), np.float32), (64, 128)).to(dev)
    with pytest.raises(ValueError, match="power of two"):
        ops.spmm(torch.ones(4, 128, device=dev), w)
    w = dense_to_bcsr(np.ones((16, 128), np.float32), (8, 128))
    with pytest.raises(ValueError, match="lies on"):
        ops.spmm(torch.ones(4, 128, device=dev), w)        # W still on the CPU
    with pytest.raises(TypeError):
        ops.spmm(torch.ones(4, 128, device=dev, dtype=torch.float16), w.to(dev))


# -- paged flash-decode attention (csrc/paged_attention.cu) -----------------

def _paged_case(dev, *, g, ps, dtype, b=4, kv=2, hd=64, c=5, p_log=7,
                starts=(0, 9, 30, 0), n_tok=(5, 1, 3, 0)):
    """A mixed tick over pools of garbage (trash page included); slot 3 is
    inactive, its page-table row all zeros."""
    gen = torch.Generator(device=dev).manual_seed(17)
    n_pages = 1 + b * p_log
    q = torch.randn(b, c, kv * g, hd, device=dev, generator=gen)
    kp = torch.randn(n_pages, ps, kv, hd, device=dev, generator=gen).to(dtype)
    vp = torch.randn(n_pages, ps, kv, hd, device=dev, generator=gen).to(dtype)
    table = (1 + torch.randperm(b * p_log, generator=gen, device=dev)
             .reshape(b, p_log)).to(torch.int32)
    table[3] = 0
    starts = torch.tensor(starts, dtype=torch.int32, device=dev)
    positions = (starts[:, None] + torch.arange(c, device=dev)).to(torch.int32)
    valid = torch.arange(c, device=dev)[None] < torch.tensor(n_tok, device=dev)[:, None]
    return q, kp, vp, table, positions, valid


def _check_paged(q, kp, vp, table, positions, valid, window, splits):
    """Kernel partials against ``paged_flash_fwd_ref`` and the wrapper
    against the gathered softmax, on valid rows, at 1e-4."""
    kv = kp.shape[2]
    b, c, h, hd = q.shape
    g = h // kv
    qg = q.reshape(b, c, kv, g, hd).permute(0, 2, 1, 3, 4).contiguous()
    before = paged_ops.launches["paged_flash_fwd"]
    got = paged_ops.paged_flash_fwd(qg, kp, vp, table, positions,
                                    window=window, kv_splits=splits)
    assert paged_ops.launches["paged_flash_fwd"] == before + 1
    torch.cuda.synchronize()
    want = paged_ref.paged_flash_fwd_ref(qg, kp, vp, table, positions,
                                         positions[:, 0], window=window,
                                         kv_splits=splits)
    rows = valid[:, None, None, :, None]           # (B, 1, 1, C, 1)
    for name, x, y in zip(("acc", "m", "l"), got, want):
        assert torch.isfinite(x).all(), name
        mask = (rows[..., None] if x.dim() == 6 else rows).expand_as(x)
        torch.testing.assert_close(x[mask], y[mask], atol=1e-4, rtol=1e-4,
                                   msg=name)
    out = paged_ops.paged_flash_attention(q, kp, vp, table, positions,
                                          window=window, kv_splits=splits)
    plain = paged_ref.paged_attention_ref(q, kp, vp, table, positions,
                                          window=window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[valid], plain[valid], atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("ps,dtype", [(16, torch.bfloat16), (16, torch.float32),
                                      (12, torch.bfloat16), (48, torch.float32)])
def test_cuda_paged_attention_matches_plain(g, window, splits, ps, dtype):
    dev = _cuda()
    _check_paged(*_paged_case(dev, g=g, ps=ps, dtype=dtype), window, splits)


# (case, keyword arguments of _paged_case, window) at the tile core's
# edges: recurrentgemma-9b's prefill tick (hd 256, g 16, C 32: 512 rows in
# 8 row tiles) with a window that leaves a valid row's split only masked
# keys; 65 and 96 rows (a ragged last row tile); f16 pools; a decode tick
# whose 16 rows fill one warp's tile; hd 72, run in the hd-128 tiles with
# the columns past hd zero-filled
PAGED_TILE_CASES = [
    ("hd256 prefill", dict(g=16, hd=256, kv=1, c=32, ps=16, p_log=10,
                           starts=(120, 0, 64, 0), n_tok=(32, 32, 9, 0)), 48),
    ("65 rows", dict(g=13, c=5, ps=16), None),
    ("96 rows", dict(g=3, c=32, ps=12, p_log=10, starts=(40, 0, 80, 0),
                     n_tok=(32, 20, 32, 0)), 24),
    ("f16 pools", dict(g=3, ps=16, dtype=torch.float16), 8),
    ("f16 pools, ps 48", dict(g=3, ps=48, dtype=torch.float16), None),
    ("decode g 16", dict(g=16, c=1, hd=256, kv=1, ps=16, p_log=12,
                         starts=(191, 17, 100, 0), n_tok=(1, 1, 1, 0)), 64),
    ("decode g 16 hd 64", dict(g=16, c=1, ps=16, starts=(100, 17, 0, 0),
                               n_tok=(1, 1, 1, 0)), None),
    ("hd 72", dict(g=3, hd=72, ps=12), 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,kw,window", PAGED_TILE_CASES,
                         ids=[c[0] for c in PAGED_TILE_CASES])
@pytest.mark.parametrize("splits", [1, 3])
def test_cuda_paged_attention_tile_edges(case, kw, window, splits):
    dev = _cuda()
    kw = {"dtype": torch.bfloat16, **kw}
    _check_paged(*_paged_case(dev, **kw), window, splits)


def _off_boundary(t):
    """t's values in a contiguous view that starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["hd 36", "q off a 16-byte boundary",
                                  "k pool off a 16-byte boundary"])
def test_cuda_paged_attention_rejects_what_the_tile_core_does_not_take(what):
    """The tile core stages 16-byte chunks, but the wrapper takes what the
    reference takes: a head_dim that is not a multiple of 8 is padded with
    zero columns, and q or a pool off a 16-byte boundary is copied to an
    aligned tensor; the kernel runs once and matches the plain version."""
    dev = _cuda()
    q, kp, vp, table, positions, valid = _paged_case(
        dev, g=2, ps=16, dtype=torch.bfloat16, hd=36 if what == "hd 36" else 64)
    if what.startswith("q "):
        q = _off_boundary(q)
    if what.startswith("k pool"):
        kp = _off_boundary(kp)
    b, c, h, hd = q.shape
    qg = q.reshape(b, c, 2, 2, hd).permute(0, 2, 1, 3, 4).contiguous()
    if what.startswith("q "):
        qg = _off_boundary(qg)
    before = paged_ops.launches["paged_flash_fwd"]
    got = paged_ops.paged_flash_fwd(qg, kp, vp, table, positions)
    assert paged_ops.launches["paged_flash_fwd"] == before + 1
    torch.cuda.synchronize()
    want = paged_ref.paged_flash_fwd_ref(qg, kp, vp, table, positions,
                                         positions[:, 0])
    rows = valid[:, None, None, :, None]
    for name, x, y in zip(("acc", "m", "l"), got, want):
        assert x.shape == y.shape, name
        mask = (rows[..., None] if x.dim() == 6 else rows).expand_as(x)
        torch.testing.assert_close(x[mask], y[mask], atol=1e-4, rtol=1e-4,
                                   msg=name)
    _check_paged(q, kp, vp, table, positions, valid, None, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 4])
def test_cuda_paged_attention_f32_pools_8192_keys(splits):
    """f32 pools over a walk of 8,192 keys and more (decode at positions
    8,200 and 8,191): the partials stay within PAGED_ATOL 1e-4 of the plain
    version (the per-tile f32 sums bound the tensor cores' own
    accumulation). Prints the worst partial error."""
    dev = _cuda()
    case = _paged_case(dev, g=3, ps=16, dtype=torch.float32, c=1, p_log=520,
                       starts=(8200, 8191, 4000, 0), n_tok=(1, 1, 1, 0))
    q, kp, vp, table, positions, valid = case
    b, c, h, hd = q.shape
    qg = q.reshape(b, c, 2, 3, hd).permute(0, 2, 1, 3, 4).contiguous()
    got = paged_ops.paged_flash_fwd(qg, kp, vp, table, positions,
                                    kv_splits=splits)
    torch.cuda.synchronize()
    want = paged_ref.paged_flash_fwd_ref(qg, kp, vp, table, positions,
                                         positions[:, 0], kv_splits=splits)
    rows = valid[:, None, None, :, None]
    worst = {}
    for name, x, y in zip(("acc", "m", "l"), got, want):
        mask = (rows[..., None] if x.dim() == 6 else rows).expand_as(x)
        rel = (x[mask] - y[mask]).abs() / (1e-4 + 1e-4 * y[mask].abs())
        worst[name] = float((x[mask] - y[mask]).abs().max())
        worst[name + " as atol"] = float(rel.max()) * 1e-4
    print(f"paged f32 pools, 8,192+ keys, {splits} split(s): worst partial "
          f"error {worst}")
    _check_paged(*case, None, splits)


@pytest.mark.gpu
def test_cuda_paged_attention_never_gathers_the_context():
    """The torch-side form of the reference's jaxpr check: a kernel-path
    ``attention.paged_attention`` call allocates less than the gathered
    (B, P*ps, KV, hd) context it avoids."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention
    dev = _cuda()
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=1)
    b, ps, p_log = 8, 16, 256
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    pools = attention.init_paged_kv(cfg, 1 + b * p_log, ps, torch.bfloat16,
                                    dev)
    p = attention.init_attention(cfg, device=dev)
    table = (1 + torch.arange(b * p_log, device=dev).reshape(b, p_log)).to(torch.int32)
    positions = torch.full((b, 1), p_log * ps - 1, dtype=torch.int32, device=dev)
    x = torch.randn(b, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    n_tok = torch.ones(b, dtype=torch.int32, device=dev)
    gathered = b * p_log * ps * kv * hd * 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    attention.paged_attention(p, x, pools, table, positions, n_tok, cfg,
                              backend="cuda", kv_splits=4)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < gathered


# -- flash attention (csrc/flash_attention.cu) -------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402

# (b, s, h, kv, hd): the JAX sweep's GQA shapes, a ragged S (not a multiple
# of the kernel's 64-row tile), smollm-360m's heads, recurrentgemma-9b's
# (16 q heads of 256 on one kv head), hd 128 at a ragged S, and hd 72 (the
# hd-128 tiles with the columns past hd zero-filled)
FLASH_SHAPES = [(2, 64, 4, 2, 32), (1, 100, 4, 1, 16), (2, 192, 15, 5, 64),
                (1, 256, 16, 1, 256), (1, 160, 8, 2, 128), (1, 100, 4, 2, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_flash_attention_matches_plain(b, s, h, kv, hd, causal, window,
                                            dtype):
    """Window 40 under the kernel's 64-row q tiles and 64-key kv tiles (32
    at hd 256): rows of a q tile whose first kv tile lies below their
    window start on a fully masked tile (the -1e30 sentinel's junk, wiped
    by the first real score)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(s + h + hd)
    q = torch.randn(b * h, s, hd, device=dev, generator=gen).to(dtype)
    k = torch.randn(b * kv, s, hd, device=dev, generator=gen).to(dtype)
    v = torch.randn(b * kv, s, hd, device=dev, generator=gen).to(dtype)
    before = flash_ops.launches["flash_attention_fwd"]
    got = flash_ops.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                        bq=s, bk=s)
    assert flash_ops.launches["flash_attention_fwd"] == before + 1
    torch.cuda.synchronize()
    want = flash_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    # f32: the same products summed in another order (the JAX kernel
    # tests' tolerance); bf16 / f16: outputs rounded from f32 sums that
    # differ in order, at most a step of the type apart
    tol = (dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2 ** -7, rtol=2 ** -7))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["hd 36", "q off a 16-byte boundary",
                                  "v off a 16-byte boundary"])
def test_cuda_flash_attention_rejects_what_the_tile_core_does_not_take(what):
    """As the paged kernel: a head_dim that is not a multiple of 8 and
    tensors off a 16-byte boundary are taken (zero columns, an aligned
    copy); the kernel runs once and matches the plain version."""
    dev = _cuda()
    hd = 36 if what == "hd 36" else 64
    q, k, v = (torch.randn(n, 64, hd, device=dev).to(torch.bfloat16)
               for n in (4, 2, 2))
    if what.startswith("q "):
        q = _off_boundary(q)
    if what.startswith("v "):
        v = _off_boundary(v)
    before = flash_ops.launches["flash_attention_fwd"]
    got = flash_ops.flash_attention_fwd(q, k, v, bq=64, bk=64)
    assert flash_ops.launches["flash_attention_fwd"] == before + 1
    torch.cuda.synchronize()
    want = flash_ref.flash_attention_ref(q, k, v, causal=True, window=None)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -7,
                               rtol=2 ** -7)


@pytest.mark.gpu
def test_cuda_flash_attention_model_layout():
    """``ops.flash_attention`` takes the (B, S, H, hd) model layout and
    equals the plain version at recurrentgemma-9b's local attention."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(1, 512, 16, 256, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(1, 512, 1, 256, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(1, 512, 1, 256, device=dev, generator=gen).to(torch.bfloat16)
    got = flash_ops.flash_attention(q, k, v, causal=True, window=128)
    want = flash_ref.flash_attention_ref(
        q.transpose(1, 2).reshape(16, 512, 256),
        k.transpose(1, 2).reshape(1, 512, 256),
        v.transpose(1, 2).reshape(1, 512, 256), causal=True, window=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               want.reshape(1, 16, 512, 256).transpose(1, 2).float(),
                               atol=2 ** -7, rtol=2 ** -7)


# ---------------------------------------------------------------------------
# Training kernels: spmm_t, SDDMM, prox-Adam, and the bf16 block store
# ---------------------------------------------------------------------------

from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.prox_adam import ops as adam_ops  # noqa: E402
from repro_torch.sparse.formats import pad_bcsr  # noqa: E402


def _train_weight(rng, n, k, block, density, dev, pad=False):
    w = dense_to_bcsr(_block_sparse(rng, n, k, block, density), block)
    if pad:      # pad_bcsr slots, as a stacked layer store carries them
        w = pad_bcsr(w, w.data.shape[0] + 5, w.gather_idx.shape[1] + 1,
                     w.gather_t_idx.shape[1] + 2)
    return w.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("m", [1, 17, 33, 512, 1000])
@pytest.mark.parametrize("pad", [False, True])
def test_cuda_spmm_t_matches_plain(n, k, block, density, m, pad):
    dev = _cuda()
    rng = np.random.default_rng(21)
    w = _train_weight(rng, n, k, block, density, dev, pad)
    for dt, st in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16)):
        wd = dataclasses.replace(w, data=w.data.to(st))
        dy = torch.tensor(rng.normal(size=(m, n)), dtype=dt, device=dev)
        before = ops.launches["spmm_t"]
        got = ops.spmm_t(dy, wd)
        assert ops.launches["spmm_t"] == before + 1
        again = ops.spmm_t(dy, wd)
        torch.cuda.synchronize()
        assert torch.equal(got, again)            # deterministic: bit-equal
        torch.testing.assert_close(got, ref.spmm_bwd_ref(dy, wd), atol=ATOL,
                                   rtol=RTOL)


def _with_empty_column(rng, n, k, block, density, col):
    """``_block_sparse`` with block-column ``col`` all zero."""
    wd = _block_sparse(rng, n, k, block, density)
    wd[:, col * block[1]:(col + 1) * block[1]] = 0.0
    return wd


@pytest.mark.gpu
@pytest.mark.parametrize("br", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("bc", [32, 128])
@pytest.mark.parametrize("m", [1, 17, 33, 512, 1000])
def test_cuda_spmm_t_every_block_height(br, bc, m):
    """Every br the tables take (16 / br blocks a k-step below 16, two
    k-steps a block at 32), ragged N and K, an all-empty block-column
    (zeros), dY on and off a 16-byte boundary, every pairing of f32 and
    bf16 dY and store; two calls give equal bits."""
    dev = _cuda()
    rng = np.random.default_rng(26)
    n, k = 37 * br + br // 2 + 1, 5 * bc - 3
    wd = _with_empty_column(rng, n, k, (br, bc), 0.4, 2)
    w = dense_to_bcsr(wd, (br, bc)).to(dev)
    assert int(w.gather_t_nnz[2]) == 0
    for dt in (torch.float32, torch.bfloat16):
        for st in (torch.float32, torch.bfloat16):
            wt = dataclasses.replace(w, data=w.data.to(st))
            dy = torch.tensor(rng.normal(size=(m, n)), dtype=dt, device=dev)
            for d in (dy, _off_boundary(dy)):
                got = ops.spmm_t(d, wt)
                again = ops.spmm_t(d, wt)
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                torch.testing.assert_close(got, ref.spmm_bwd_ref(d, wt),
                                           atol=ATOL, rtol=RTOL)
                assert (got[:, 2 * bc:3 * bc] == 0).all()


def _decode_weight(rng, br, bc, dev, pad):
    """(7 br + 3, 5 bc - 3) at 0.3 block density with block-row 1 fully
    resident (a row of jmax blocks), ragged N and K; with ``pad``, the
    tables are padded past every row's count."""
    n, k = 7 * br + 3, 5 * bc - 3
    wd = _block_sparse(rng, n, k, (br, bc), 0.3)
    wd[br:2 * br] = rng.normal(size=(br, k))
    w = dense_to_bcsr(wd, (br, bc))
    if pad:
        w = pad_bcsr(w, w.data.shape[0] + 3, w.gather_idx.shape[1] + 2,
                     w.gather_t_idx.shape[1] + 1)
    return w.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("br", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("bc", [64, 128])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "palette8",
                                   "palette4"])
@pytest.mark.parametrize("pad", [False, True])
def test_cuda_decode_kernel_matches_plain(br, bc, store, pad):
    """The decode kernel, forced through ``ops._fwd(x, w, "decode")``, at
    every M from 1 to 16 and every br, for each store, f32 and bf16 x, a
    block-row of jmax resident blocks beside rows with fewer, and padded
    tables (nnz < jmax everywhere)."""
    dev = _cuda()
    rng = np.random.default_rng(27)
    w = _decode_weight(rng, br, bc, dev, pad)
    if store.startswith("palette"):
        w, plain = quantize_bcsr(w, int(store[7:])), ref.spmm_palette_fwd_ref
    else:
        w = dataclasses.replace(w, data=w.data.to(getattr(torch, store)))
        plain = ref.spmm_fwd_ref
    assert int(w.gather_nnz[1]) == w.block_grid[1]
    key = ("spmm_palette" if store.startswith("palette") else "spmm") \
        + "_decode"
    for m in range(1, ops.DECODE_MAX_M + 1):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.normal(size=(m, w.shape[1])), dtype=dt,
                             device=dev)
            before = ops.variant_launches[key]
            got = ops._fwd(x, w, "decode")
            torch.cuda.synchronize()
            assert ops.variant_launches[key] == before + 1
            torch.testing.assert_close(got, plain(x, w), atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("m", [4, 256, 512])
def test_cuda_spmm_bf16_store_matches_plain(n, k, block, m):
    dev = _cuda()
    rng = np.random.default_rng(22)
    w = _train_weight(rng, n, k, block, 0.2, dev)
    wb = dataclasses.replace(w, data=w.data.to(torch.bfloat16))
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.bfloat16, device=dev)
    got = ops.spmm(x, wb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.spmm_fwd_ref(x, wb), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("m", [1, 33, 512])
@pytest.mark.parametrize("pad", [False, True])
def test_cuda_sddmm_matches_plain(n, k, block, density, m, pad):
    dev = _cuda()
    rng = np.random.default_rng(23)
    w = _train_weight(rng, n, k, block, density, dev, pad)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.normal(size=(m, k)), dtype=dt, device=dev)
        dy = torch.tensor(rng.normal(size=(m, n)), dtype=dt, device=dev)
        before = sddmm_ops.launches["bsr_sddmm"]
        got = sddmm_ops.bsr_weight_grad(x, dy, w)
        assert sddmm_ops.launches["bsr_sddmm"] == before + 1
        again = sddmm_ops.bsr_weight_grad(x, dy, w)
        torch.cuda.synchronize()
        assert torch.equal(got, again)            # deterministic: bit-equal
        want = sddmm_ops.bsr_weight_grad_ref(x, dy, w)
        torch.testing.assert_close(got, want, atol=ATOL * max(1, m / 32),
                                   rtol=RTOL)
        _, _, valid = sddmm_ops.slot_coordinates(w)
        assert (got[~valid] == 0).all()
        if density == 0.0:
            assert (got == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block,density", [
    (2048, 256, (8, 128), 0.8),       # ~200 slots share each block-column
    (4096, 960, (8, 128), 0.5),       # recurrentgemma-like height, smollm width
    (256, 192, (64, 64), 0.5),        # blocks the forward does not take
    (96, 200, (12, 40), 0.5),         # br not a power of two, ragged bc
])
@pytest.mark.parametrize("m", [64, 512])
def test_cuda_sddmm_shared_columns_and_other_blocks(n, k, block, density, m):
    """Slots that share a block-column share one staged X slab; many slots
    a column, M split across thread blocks, and blocks past (8, 128): the
    kernel matches the plain version and is bit-equal run to run."""
    dev = _cuda()
    rng = np.random.default_rng(25)
    w = _train_weight(rng, n, k, block, density, dev)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.normal(size=(m, k)), dtype=dt, device=dev)
        dy = torch.tensor(rng.normal(size=(m, n)), dtype=dt, device=dev)
        got = sddmm_ops.bsr_weight_grad(x, dy, w)
        again = sddmm_ops.bsr_weight_grad(x, dy, w)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want = sddmm_ops.bsr_weight_grad_ref(x, dy, w)
        torch.testing.assert_close(got, want, atol=ATOL * max(1, m / 32),
                                   rtol=RTOL)
        _, _, valid = sddmm_ops.slot_coordinates(w)
        assert (got[~valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 1000, 4097, 2560 * 960])
@pytest.mark.parametrize("rule", ["adam", "rmsprop"])
@pytest.mark.parametrize("prox", [True, False])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_cuda_prox_adam_matches_plain(n, rule, prox, wdt):
    dev = _cuda()
    rng = np.random.default_rng(24)
    mk = lambda s=1.0: torch.tensor(rng.normal(size=n) * s,  # noqa: E731
                                    dtype=torch.float32, device=dev)
    w, g, m = mk().to(wdt), mk(), mk(0.1)
    v = mk(0.1).abs()
    sc = adam_ops.make_scalars(1e-2, 3.0, 0.9, 0.999, 1e-8, 7)
    want = adam_ops.fused_prox_update_ref(w, g, m, v, sc, rule=rule,
                                          apply_prox=prox)
    before = adam_ops.launches["prox_adam"]
    got = adam_ops.fused_update_leaf(w, g, m, v, sc, rule=rule,
                                     apply_prox=prox)
    assert adam_ops.launches["prox_adam"] == before + 1
    assert got[0] is w                            # in place
    torch.cuda.synchronize()
    # the same f32 operations in the same order, each rounded to nearest
    # (the kernel contracts no FMA), so w, also after its bf16 rounding,
    # m and v agree to 1e-6
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
def test_cuda_prox_adam_unaligned_view():
    """A leaf that starts off a 16-byte boundary takes the scalar path."""
    dev = _cuda()
    base = torch.randn(1001, device=dev)
    w, g = base[1:], torch.randn(1000, device=dev)
    m, v = torch.zeros(1000, device=dev), torch.zeros(1000, device=dev)
    sc = adam_ops.make_scalars(1e-2, 0.5, 0.9, 0.999, 1e-8, 1)
    want = adam_ops.fused_prox_update_ref(w, g, m, v, sc)
    adam_ops.fused_update_leaf(w, g, m, v, sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(w, want[0], atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 3, 512, 512), (5, 5, 20, 50), (10,)])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_prox_adam_cnn_leaves_match_plain(shape, masked):
    """The CNN pipeline's leaves through ``core.optimizers.prox_adam``:
    VGG16's largest filter (HWIO, 2,359,296 entries), LeNet-5's conv2 and
    a 10-entry bias (no prox), with and without a debias mask. Three steps
    on the card (one launch a leaf a step) against the same steps on a
    copy on the CPU, the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    name = "bias" if len(shape) == 1 else "w"
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    grads = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    mask = (np.abs(w) > 0.02).astype(np.float32) if masked else None
    opt = prox_adam(1e-3, lam=1.0)
    out = {}
    for d in ("cuda", "cpu"):
        p = {"leaf": {name: torch.from_numpy(w).to(d)}}
        state = opt.init(p)
        mk = None if mask is None else {
            "leaf": {name: torch.from_numpy(mask).to(d)}}
        before = adam_ops.launches["prox_adam"]
        for g in grads:
            with torch.no_grad():
                p, state = opt.update({"leaf": {name: torch.from_numpy(g)
                                                .to(d)}}, state, p, mask=mk)
        if d == "cuda":
            assert adam_ops.launches["prox_adam"] == before + 3
        out[d] = (p["leaf"][name].cpu(), state.m["leaf"][name].cpu(),
                  state.v["leaf"][name].cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    if masked:
        assert (out["cuda"][0][torch.from_numpy(mask) == 0] == 0).all()


# ---------------------------------------------------------------------------
# The expert axis: one launch of the forward kernels over E stacked
# matrices (the MoE FFN's compressed experts)
# ---------------------------------------------------------------------------

def _expert_stack(rng, e, n, k, block, dev, store="float32"):
    """E BlockCSR slices of (n, k) at block densities 0.05-0.5 (expert 0
    all zero), padded to common widths and stacked as the compression
    stacks them; ``store`` "float32", "bfloat16", "palette8", "palette4"."""
    ms = [dense_to_bcsr(_block_sparse(rng, n, k, block, 0.0 if i == 0 else
                                      0.05 + 0.45 * i / e), block)
          for i in range(e)]
    w = _pad_stack(ms, CompressionPlan(min_sparsity=0.0), (e,),
                   1 << 40).to(dev)
    if store.startswith("palette"):
        return quantize_bcsr(w, int(store[7:]))
    return dataclasses.replace(w, data=w.data.to(getattr(torch, store)))


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16", "palette8",
                                   "palette4"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40])
@pytest.mark.parametrize("n,k,block", [(256, 384, (8, 128)),
                                       (100, 70, (8, 64)), (96, 160, (32, 32))])
def test_cuda_spmm_experts_matches_plain_and_singles(store, x_dtype, m, n, k,
                                                     block):
    """``spmm_experts`` / ``spmm_palette_experts`` over 5 experts on the
    form M picks: one launch, counted under the expert wrapper and its
    variant; within tolerance of the plain version (a loop of the
    single-matrix plain version); bit-equal to a second call, and each
    expert's slice bit-equal to a call on that expert alone (E = 1)."""
    dev = _cuda()
    rng = np.random.default_rng(31)
    e = 5
    w = _expert_stack(rng, e, n, k, block, dev, store)
    palette = store.startswith("palette")
    wrapper = "spmm_palette_experts" if palette else "spmm_experts"
    plain = (ref.spmm_palette_experts_fwd_ref if palette
             else ref.spmm_experts_fwd_ref)
    x = torch.tensor(rng.normal(size=(e, m, k)), dtype=x_dtype, device=dev)
    kern = ops.pick_kernel(m)
    before, var = ops.launches[wrapper], ops.variant_launches[f"{wrapper}_{kern}"]
    got = getattr(ops, wrapper)(x, w)
    torch.cuda.synchronize()
    assert ops.launches[wrapper] == before + 1
    assert ops.variant_launches[f"{wrapper}_{kern}"] == var + 1
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, plain(x, w), atol=ATOL, rtol=RTOL)
    assert torch.equal(getattr(ops, wrapper)(x, w), got)
    for i in range(e):
        one = w.map(lambda t, i=i: t[i:i + 1].contiguous())
        assert torch.equal(getattr(ops, wrapper)(x[i:i + 1], one)[0], got[i])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["decode", "tile"])
@pytest.mark.parametrize("store", ["float32", "bfloat16", "palette8",
                                   "palette4"])
def test_cuda_spmm_experts_one_expert_is_its_slice_of_the_stack(kernel,
                                                                 store):
    """Forced onto each form, at olmoe's (8, 128) blocks, f32 and bf16 x,
    without counts and with them: each expert of a stack of 5, called
    alone (E = 1), is bit-equal to its slice of the stack's output, and
    two calls on the stack are bit-equal (each output's sum has one order,
    and no expert's output depends on another's)."""
    dev = _cuda()
    rng = np.random.default_rng(32)
    e = 5
    w = _expert_stack(rng, e, 2048, 1024, (8, 128), dev, store)
    for dt in (torch.float32, torch.bfloat16):
        for m in (4, 40):
            x = torch.tensor(rng.normal(size=(e, m, 1024)), dtype=dt,
                             device=dev)
            counts = torch.tensor([0, 1, m // 2, m, m], dtype=torch.int32,
                                  device=dev)
            for rows in (None, counts):
                got = ops._fwd(x, w, kernel, rows)
                assert torch.equal(ops._fwd(x, w, kernel, rows), got)
                for i in range(e):
                    one = w.map(lambda t, i=i: t[i:i + 1].contiguous())
                    r = None if rows is None else rows[i:i + 1]
                    alone = ops._fwd(x[i:i + 1], one, kernel, r)
                    assert torch.equal(alone[0], got[i]), (dt, m, rows, i)


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16", "palette8",
                                   "palette4"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 16, 40])
@pytest.mark.parametrize("n,k,block", [(256, 384, (8, 128)),
                                       (100, 70, (8, 64)), (96, 160, (32, 32))])
def test_cuda_spmm_experts_rows_match_plain(store, x_dtype, m, n, k, block):
    """The expert forward with each expert's occupied rows (counts 0, 1, a
    partial count, M and past M; X random past each count, which the
    kernel must not read into Y), on both forms: within tolerance of the
    plain version with the same counts, exact zeros past each count, one
    launch each; with every row occupied, bit-equal to the call without
    counts."""
    dev = _cuda()
    rng = np.random.default_rng(34)
    e = 5
    w = _expert_stack(rng, e, n, k, block, dev, store)
    palette = store.startswith("palette")
    wrapper = "spmm_palette_experts" if palette else "spmm_experts"
    plain = (ref.spmm_palette_experts_fwd_ref if palette
             else ref.spmm_experts_fwd_ref)
    x = torch.tensor(rng.normal(size=(e, m, k)), dtype=x_dtype, device=dev)
    counts = [0, 1, max(m // 2, 1), m, m + 3]
    rows = torch.tensor(counts, dtype=torch.int32, device=dev)
    want = plain(x, w, rows)
    for kern in ops.KERNELS:
        before = ops.launches[wrapper]
        got = ops._fwd(x, w, kern, rows)
        torch.cuda.synchronize()
        assert ops.launches[wrapper] == before + 1
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        for i, r in enumerate(counts):
            assert not bool(got[i, r:].any()), (kern, i, r)
        full = torch.full((e,), m, dtype=torch.int32, device=dev)
        assert torch.equal(ops._fwd(x, w, kern, full), ops._fwd(x, w, kern))
    got = getattr(ops, wrapper)(x, w, rows)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_cuda_spmm_experts_rejects_bad_rows():
    dev = _cuda()
    rng = np.random.default_rng(35)
    w = _expert_stack(rng, 3, 64, 128, (8, 64), dev)
    x = torch.ones(3, 4, 128, device=dev)
    for rows in (torch.ones(2, dtype=torch.int32, device=dev),   # 2 != 3
                 torch.ones(3, dtype=torch.int64, device=dev),   # not int32
                 torch.ones(3, dtype=torch.int32)):              # on the host
        with pytest.raises(ValueError, match="rows"):
            ops.spmm_experts(x, w, rows)


@pytest.mark.gpu
def test_cuda_spmm_experts_rejects_mismatched_stacks():
    dev = _cuda()
    rng = np.random.default_rng(33)
    w = _expert_stack(rng, 3, 64, 128, (8, 64), dev)
    with pytest.raises(ValueError):
        ops.spmm_experts(torch.ones(2, 4, 128, device=dev), w)   # 2 != 3
    with pytest.raises(ValueError):
        ops.spmm(torch.ones(4, 128, device=dev), w)              # a stack
    with pytest.raises(ValueError):
        ops.spmm_experts(torch.ones(4, 128, device=dev), w)      # 2-D x


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_palettes_match_the_cpu(bits):
    """``quantize_bcsr`` of an expert stack on the card (atomic sums, the
    assignment by ``nearest_sorted``) against the same on the CPU (ordered
    sums, the full argmin): palettes within 1e-3 (the weights are O(1),
    8-bit palette entries about 0.03 apart, clusters of about 100 values:
    a value the two sums' rounding moves across a boundary shifts its two
    clusters' means by about 3e-4), codes equal but for a few such
    entries."""
    dev = _cuda()
    rng = np.random.default_rng(34)
    w = _expert_stack(rng, 6, 256, 384, (8, 128), "cpu")
    q_cpu, q_dev = quantize_bcsr(w, bits), quantize_bcsr(w.to(dev), bits)
    torch.testing.assert_close(q_dev.palette.cpu(), q_cpu.palette,
                               atol=1e-3, rtol=0)
    same = (q_dev.codes.cpu() == q_cpu.codes).float().mean()
    assert float(same) > 0.999


# ---------------------------------------------------------------------------
# The expert axis of the backward: spmm_t and the SDDMM over E stacked
# matrices in one launch each (MoE training through compressed experts)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("e", [1, 5, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 17, 80, 129])
@pytest.mark.parametrize("n,k,block", [(256, 384, (8, 128)), (100, 70, (8, 64)),
                                       (96, 160, (32, 32))])
def test_cuda_expert_backward_matches_plain(e, dtype, m, n, k, block):
    """``spmm_t_experts`` and ``bsr_weight_grad_experts`` over E experts
    (expert 0 with no resident block; the stores padded to the widest
    expert; M not a multiple of 16 or 64; f32 and bf16 operands and store):
    one launch each, within tolerance of their plain versions (loops of
    the single-matrix plain versions), every padded slot of every expert
    zero, bit-equal run to run."""
    dev = _cuda()
    rng = np.random.default_rng(35)
    w = _expert_stack(rng, e, n, k, block, dev, str(dtype).split(".")[-1])
    assert int(w.gather_nnz[0].sum()) == 0
    x = torch.tensor(rng.normal(size=(e, m, k)), dtype=dtype, device=dev)
    dy = torch.tensor(rng.normal(size=(e, m, n)), dtype=dtype, device=dev)
    before = (ops.launches["spmm_t_experts"],
              sddmm_ops.launches["bsr_sddmm_experts"])
    dx = ops.spmm_t_experts(dy, w)
    dw = sddmm_ops.bsr_weight_grad_experts(x, dy, w)
    assert (ops.launches["spmm_t_experts"],
            sddmm_ops.launches["bsr_sddmm_experts"]) == (before[0] + 1,
                                                         before[1] + 1)
    again = (ops.spmm_t_experts(dy, w),
             sddmm_ops.bsr_weight_grad_experts(x, dy, w))
    torch.cuda.synchronize()
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    assert dx.shape == (e, m, k) and dw.shape == (e,) + tuple(w.data.shape[1:])
    torch.testing.assert_close(dx, ref.spmm_experts_bwd_ref(dy, w), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(
        dw, sddmm_ops.bsr_weight_grad_experts_ref(x, dy, w),
        atol=ATOL * max(1, m / 32), rtol=RTOL)
    _, _, valid = sddmm_ops.slot_coordinates(w)
    assert valid.shape == w.data.shape[:2]
    assert (dw[~valid] == 0).all() and (dw[0] == 0).all() and (dx[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_expert_backward_one_expert_matches_single_kernels_and_its_slice(dtype):
    """E = 1: the expert kernels on one expert within tolerance of the
    single-matrix ``spmm_t`` and SDDMM on the same slice (another kernel,
    another order of the f32 sums), and bit-equal to that expert's slice of
    a call on the stack."""
    dev = _cuda()
    rng = np.random.default_rng(36)
    w = _expert_stack(rng, 2, 1024, 2048, (8, 128), dev,
                      str(dtype).split(".")[-1])
    w1 = w.map(lambda t: t[1:2].contiguous())
    for m in (8, 80):
        x = torch.tensor(rng.normal(size=(2, m, 2048)), dtype=dtype, device=dev)
        dy = torch.tensor(rng.normal(size=(2, m, 1024)), dtype=dtype,
                          device=dev)
        dx1 = ops.spmm_t_experts(dy[1:], w1)
        dw1 = sddmm_ops.bsr_weight_grad_experts(x[1:], dy[1:], w1)
        torch.testing.assert_close(dx1[0], ops.spmm_t(dy[1], w1[0]),
                                   atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(
            dw1[0], sddmm_ops.bsr_weight_grad(x[1], dy[1], w1[0]),
            atol=ATOL * max(1, m / 32), rtol=RTOL)
        assert torch.equal(ops.spmm_t_experts(dy, w)[1], dx1[0])
        assert torch.equal(sddmm_ops.bsr_weight_grad_experts(x, dy, w)[1],
                           dw1[0])


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 17, 80, 129])
@pytest.mark.parametrize("n,k,block", [(256, 384, (8, 128)), (100, 70, (8, 64)),
                                       (96, 160, (32, 32)), (64, 96, (2, 16)),
                                       (48, 40, (1, 8))])
def test_cuda_expert_backward_rows_match_plain(store, dtype, m, n, k, block):
    """The expert backward with each expert's occupied rows (counts 0, 1,
    a partial count, M and past M; x and dY random past each count, which
    the kernels must not read): one launch each, within tolerance of the
    plain versions with the same counts; dx exact zeros past each count,
    an expert with no token all zeros in dx and dw, every padded slot
    zero; bit-equal run to run; each expert's slice bit-equal to a call on
    that expert alone with its count; with every row occupied, bit-equal
    to the calls without counts."""
    dev = _cuda()
    rng = np.random.default_rng(38)
    e = 5
    w = _expert_stack(rng, e, n, k, block, dev, store)
    x = torch.tensor(rng.normal(size=(e, m, k)), dtype=dtype, device=dev)
    dy = torch.tensor(rng.normal(size=(e, m, n)), dtype=dtype, device=dev)
    counts = [0, 1, max(m // 2, 1), m, m + 3]
    rows = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = (ops.launches["spmm_t_experts"],
              sddmm_ops.launches["bsr_sddmm_experts"])
    dx = ops.spmm_t_experts(dy, w, rows)
    dw = sddmm_ops.bsr_weight_grad_experts(x, dy, w, rows)
    torch.cuda.synchronize()
    assert (ops.launches["spmm_t_experts"],
            sddmm_ops.launches["bsr_sddmm_experts"]) == (before[0] + 1,
                                                         before[1] + 1)
    torch.testing.assert_close(dx, ref.spmm_experts_bwd_ref(dy, w, rows),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(
        dw, sddmm_ops.bsr_weight_grad_experts_ref(x, dy, w, rows),
        atol=ATOL * max(1, m / 32), rtol=RTOL)
    for i, r in enumerate(counts):
        assert not bool(dx[i, r:].any()), (i, r)
    assert not bool(dx[0].any()) and not bool(dw[0].any())
    _, _, valid = sddmm_ops.slot_coordinates(w)
    assert not bool(dw[~valid].any())
    assert torch.equal(ops.spmm_t_experts(dy, w, rows), dx)
    assert torch.equal(sddmm_ops.bsr_weight_grad_experts(x, dy, w, rows), dw)
    for i in range(e):
        one = w.map(lambda t, i=i: t[i:i + 1].contiguous())
        r = rows[i:i + 1]
        assert torch.equal(ops.spmm_t_experts(dy[i:i + 1], one, r)[0], dx[i])
        assert torch.equal(
            sddmm_ops.bsr_weight_grad_experts(x[i:i + 1], dy[i:i + 1], one,
                                              r)[0], dw[i])
    full = torch.full((e,), m, dtype=torch.int32, device=dev)
    assert torch.equal(ops.spmm_t_experts(dy, w, full),
                       ops.spmm_t_experts(dy, w))
    assert torch.equal(sddmm_ops.bsr_weight_grad_experts(x, dy, w, full),
                       sddmm_ops.bsr_weight_grad_experts(x, dy, w))


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 80])
def test_cuda_expert_backward_bf16_dy_equals_f32_dy_of_its_values(store, m):
    """dY in bf16 against f32 dY that holds the same bf16 values (the
    cotangent a cast to bf16 gives, widened or not): within 1e-5 of the
    largest |value| in dx and dw, with and without counts (the two forms
    sum the same products, the f32 one as three parts whose two lower are
    zero, in another order)."""
    dev = _cuda()
    rng = np.random.default_rng(39)
    e = 5
    w = _expert_stack(rng, e, 1024, 2048, (8, 128), dev, store)
    x = torch.tensor(rng.normal(size=(e, m, 2048)), dtype=torch.bfloat16,
                     device=dev)
    dy = torch.tensor(rng.normal(size=(e, m, 1024)), dtype=torch.bfloat16,
                      device=dev)
    rows = torch.tensor([0, 1, m // 2, m, m], dtype=torch.int32, device=dev)
    for r in (None, rows):
        for a, b in ((ops.spmm_t_experts(dy, w, r),
                      ops.spmm_t_experts(dy.float(), w, r)),
                     (sddmm_ops.bsr_weight_grad_experts(x, dy, w, r),
                      sddmm_ops.bsr_weight_grad_experts(x, dy.float(), w, r))):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_cuda_expert_backward_rejects_bad_rows():
    dev = _cuda()
    rng = np.random.default_rng(40)
    w = _expert_stack(rng, 3, 64, 128, (8, 64), dev)
    dy, x = torch.ones(3, 4, 64, device=dev), torch.ones(3, 4, 128, device=dev)
    for rows in (torch.ones(2, dtype=torch.int32, device=dev),   # 2 != 3
                 torch.ones(3, dtype=torch.int64, device=dev),   # not int32
                 torch.ones(3, dtype=torch.int32)):              # on the host
        with pytest.raises(ValueError, match="rows"):
            ops.spmm_t_experts(dy, w, rows)
        with pytest.raises(ValueError, match="rows"):
            sddmm_ops.bsr_weight_grad_experts(x, dy, w, rows)


@pytest.mark.gpu
def test_cuda_expert_backward_rejects_mismatched_stacks():
    dev = _cuda()
    rng = np.random.default_rng(37)
    w = _expert_stack(rng, 3, 64, 128, (8, 64), dev)
    with pytest.raises(ValueError):
        ops.spmm_t_experts(torch.ones(2, 4, 64, device=dev), w)        # 2 != 3
    with pytest.raises(ValueError):
        ops.spmm_t(torch.ones(4, 64, device=dev), w)                   # a stack
    with pytest.raises(ValueError):
        sddmm_ops.bsr_weight_grad_experts(torch.ones(2, 4, 128, device=dev),
                                          torch.ones(2, 4, 64, device=dev), w)
    with pytest.raises(ValueError):
        sddmm_ops.bsr_weight_grad(torch.ones(4, 128, device=dev),
                                  torch.ones(4, 64, device=dev), w)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_cuda_recurrent_debias_step_matches_plain(arch):
    """One debias step of the reduced recurrent family (f32, (8, 16) blocks
    pruned at 0.6, batch 4 x 64) on the kernels (``sparse_backend``
    'auto': the spmm forward, ``spmm_t`` and the SDDMM on every compressed
    projection) against the plain path ('ref') from the same params: the
    loss within 1e-5 relative, every leaf's gradient within 1e-3 of its
    largest |value| (the training agreement of ``chip_smoke.py``), one
    launch of each kernel per compressed matrix and layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_path, unflatten_like
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops
    from repro_torch.models.model_zoo import build
    from repro_torch.sparse import compress as tc
    from repro_torch.train.step import make_loss_fn
    dev = _cuda()
    cfg = get_config(arch).reduced()
    plan = tc.CompressionPlan(block=(8, 16), min_sparsity=0.3)
    params = build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    cp = tc.compress_params(tc.prune_blocks_for_plan(params, plan, 0.6), plan)
    per_pass = sum(m.data.shape[0] if m.data.dim() == 4 else 1
                   for _, m in tc.iter_bcsr(cp))
    assert any("/rec/" in p or "/tm/" in p for p, _ in tc.iter_bcsr(cp))
    trainable, rebuild = tc.split_trainable(cp)
    batch = token_batch(TokenStreamConfig(vocab=cfg.vocab, seq_len=64,
                                          global_batch=4), 0, device=dev)
    runs = {}
    for backend in ("auto", "ref"):
        model = build(cfg, device=dev, sparse_backend=backend)
        flat = flatten_with_path(trainable)
        leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
        ops.reset_launches()
        sddmm_ops.reset_launches()
        loss, _ = make_loss_fn(model, param_transform=rebuild)(
            unflatten_like(trainable, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        runs[backend] = (float(loss), dict(ops.launches),
                         dict(sddmm_ops.launches),
                         {"/".join(k): g for (k, _), g in zip(flat, grads)})
    (lk, fwd, dw, gk), (lp, plain_fwd, _, gp) = runs["auto"], runs["ref"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    assert fwd["spmm"] == fwd["spmm_t"] == dw["bsr_sddmm"] == per_pass > 0
    assert plain_fwd["spmm"] == 0
    for k, want in gp.items():
        got = gk[k]
        if want is None:
            assert got is None, k
            continue
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * scale, k
