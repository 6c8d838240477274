"""A CPU rehearsal of the arithmetic of ``csrc/attn_tile.cuh``.

The paged and flash attention kernels run their products on the tensor
cores in bf16 (or f16) with f32 sums, while their plain versions compute in
f32 and the kernels are held to them at 1e-4. The kernels cannot run here,
so this file emulates each kernel's tiling and operand scheme in PyTorch
and holds the emulation to the plain versions and to the JAX package's
Pallas kernels (interpret mode), at the tolerances the card's checks use:

* paged: 64-row tiles of the C*g rows (16 where C*g <= 16), kv tiles of
  consecutive logical key positions of a split's running pages, the
  skipping of kv tiles that no row sees where every row sees a key of its
  split, and the three kinds of key column (a visible key, a masked key of
  a running page at -1e30, a padded slot at -inf); f32 q and P split into
  bf16 (f16 for f16 pools) hi and lo parts, K and V too for f32 pools, the
  products of the parts summed in f32 (a product of two 16-bit values is
  exact in f32, so the emulation is faithful up to the order of the sums);
* flash: 64-row q tiles, kv tiles of 64 keys (32 at hd 256) between the
  window floor and the causal frontier, rows past S masked at the ragged
  edge; bf16 / f16 inputs as they are with P rounded once to their type,
  f32 inputs split into three products.

A single bf16 rounding of q misses the paged tolerance, which is why the
kernel splits it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash
from repro.kernels.paged_attention.paged_attention import paged_flash_fwd
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.paged_attention import ref as paged_ref
from torch_parity import jax_numpy

PAGED_ATOL = 1e-4                     # chip_smoke.py and the GPU tests
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -7),
             torch.float16: (2 ** -7, 2 ** -7)}
NEG_INF = -1e30


def kv_tile(hd: int) -> int:
    return 32 if hd > 128 else 64


def split(x, dtype, parts: int) -> list:
    """f32 ``x`` as ``parts`` 16-bit parts (hi, then lo = x - hi), each
    returned widened to f32."""
    hi = x.to(dtype).float()
    return [hi] if parts == 1 else [hi, (x - hi).to(dtype).float()]


def products(a_parts, b_parts, fn):
    """Sum in f32 of fn(a_i, b_j) over the parts with i + j <= 1 (the
    kernel drops lo x lo)."""
    terms = [fn(a, b) for i, a in enumerate(a_parts)
             for j, b in enumerate(b_parts) if i + j <= 1]
    return sum(terms[1:], terms[0])


def _online(state, sc, v_parts, op_dtype, p_parts):
    """One kv tile's online-softmax update of (m, l, acc)."""
    m, l, acc = state
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[:, None])
    corr = torch.exp(m - m_new)
    pv = products(split(p, op_dtype, p_parts), v_parts, lambda a, b: a @ b)
    return m_new, corr * l + p.sum(-1), corr[:, None] * acc + pv


def emulate_paged(qg, kp, vp, table, positions, *, window=None,
                  kv_splits=1, q_parts=2):
    """The paged kernel's arithmetic: partials (acc, m, l) shaped as
    ``ref.paged_flash_fwd_ref``'s. ``q_parts=1`` rounds q once instead of
    splitting it."""
    b, kv, c, g, hd = qg.shape
    ps, n_logical = kp.shape[1], table.shape[1]
    pps = paged_ref.pages_per_split(n_logical, kv_splits)
    rows = c * g
    tile_rows = 16 if rows <= 16 else 64
    bk = kv_tile(hd)
    op = torch.float16 if kp.dtype == torch.float16 else torch.bfloat16
    kv_parts = 2 if kp.dtype == torch.float32 else 1
    scale = hd ** -0.5
    q_rows = qg.reshape(b, kv, rows, hd).float()
    acc = torch.zeros(b, kv, kv_splits, rows, hd)
    m = torch.full((b, kv, kv_splits, rows), NEG_INF)
    l = torch.zeros(b, kv, kv_splits, rows)
    for bi in range(b):
        pos = positions[bi].long()
        start = int(pos[0])
        for s in range(kv_splits):
            page_lo = s * pps
            page_hi = min(page_lo + pps, n_logical, (start + c - 1) // ps + 1)
            run_lo = page_lo
            if window is not None and start - window + 2 - ps > 0:
                run_lo = max(run_lo, -(-(start - window + 2 - ps) // ps))
            for h in range(kv):
                for r0 in range(0, rows, tile_rows):
                    r = torch.arange(r0, min(r0 + tile_rows, rows))
                    qpos = pos[r // g]
                    key_lo, key_end = run_lo * ps, page_hi * ps
                    qmin, qmax = int(qpos.min()), int(qpos.max())
                    if (key_lo < key_end and key_lo <= qmin
                            and (window is None or qmax - window + 2 <= key_end)):
                        if window is not None:
                            key_lo = max(key_lo, qmin - window + 1)
                        key_end = min(key_end, qmax + 1)
                    q_p = split(q_rows[bi, h, r], op, q_parts)
                    state = (torch.full((len(r),), NEG_INF),
                             torch.zeros(len(r)), torch.zeros(len(r), hd))
                    for k0 in range(key_lo, key_end, bk):
                        kpos = torch.arange(k0, k0 + bk)
                        real = kpos < key_end
                        kc = kpos.clamp(max=key_end - 1)
                        phys = table[bi, kc // ps].long()
                        zero = (~real)[:, None]
                        kt = kp[phys, kc % ps, h].float().masked_fill(zero, 0)
                        vt = vp[phys, kc % ps, h].float().masked_fill(zero, 0)
                        sc = products(q_p, split(kt, op, kv_parts),
                                      lambda a, b_: a @ b_.T) * scale
                        vis = qpos[:, None] >= kpos[None]
                        if window is not None:
                            vis &= (qpos[:, None] - kpos[None]) < window
                        sc = torch.where(vis, sc, NEG_INF)
                        sc = torch.where(real[None], sc, float("-inf"))
                        state = _online(state, sc, split(vt, op, kv_parts),
                                        op, 2)
                    m[bi, h, s, r], l[bi, h, s, r], acc[bi, h, s, r] = state
    return (acc.reshape(b, kv, kv_splits, c, g, hd),
            m.reshape(b, kv, kv_splits, c, g), l.reshape(b, kv, kv_splits, c, g))


def emulate_flash(q, k, v, *, causal=True, window=None):
    """The flash kernel's arithmetic for q (BH, S, hd), k / v (BKV, S, hd);
    the output in q's dtype."""
    bh, s, hd = q.shape
    g = bh // k.shape[0]
    bk = kv_tile(hd)
    parts = 2 if q.dtype == torch.float32 else 1
    op = torch.float16 if q.dtype == torch.float16 else torch.bfloat16
    scale = hd ** -0.5
    out = torch.empty(bh, s, hd)
    for h in range(bh):
        kh, vh = k[h // g].float(), v[h // g].float()
        for q0 in range(0, s, 64):
            n = min(64, s - q0)
            qpos = torch.arange(q0, q0 + n)
            key_end = q0 + n if causal else s
            key_lo = max(0, q0 - window + 1) if window else 0
            q_p = split(q[h, q0:q0 + n].float(), op, parts)
            state = (torch.full((n,), NEG_INF), torch.zeros(n),
                     torch.zeros(n, hd))
            for k0 in range(key_lo, key_end, bk):
                kpos = torch.arange(k0, k0 + bk)
                real = kpos < s
                kt = torch.zeros(bk, hd)
                vt = torch.zeros(bk, hd)
                kt[real], vt[real] = kh[kpos[real]], vh[kpos[real]]
                sc = products(q_p, split(kt, op, parts),
                              lambda a, b_: a @ b_.T) * scale
                vis = torch.ones(n, bk, dtype=torch.bool)
                if causal:
                    vis &= qpos[:, None] >= kpos[None]
                if window:
                    vis &= (qpos[:, None] - kpos[None]) < window
                sc = torch.where(vis, sc, NEG_INF)
                sc = torch.where(real[None], sc, float("-inf"))
                state = _online(state, sc, split(vt, op, parts), op, parts)
            _, l, acc = state
            out[h, q0:q0 + n] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


# -- paged ---------------------------------------------------------------

def _paged_scenario(seed, *, g, hd, c, ps, p_log, starts, n_tok, kv=2,
                    dtype=torch.bfloat16):
    """A tick over pools of garbage; the page table is a permutation, the
    last slot inactive (all its pages the trash page 0)."""
    rng = np.random.default_rng(seed)
    b = len(starts)
    n_pages = 1 + b * p_log
    q = torch.tensor(rng.normal(size=(b, c, kv * g, hd)), dtype=torch.float32)
    kp = torch.tensor(rng.normal(size=(n_pages, ps, kv, hd)),
                      dtype=torch.float32).to(dtype)
    vp = torch.tensor(rng.normal(size=(n_pages, ps, kv, hd)),
                      dtype=torch.float32).to(dtype)
    table = torch.tensor(1 + rng.permutation(b * p_log).reshape(b, p_log),
                         dtype=torch.int32)
    table[-1] = 0
    positions = (torch.tensor(starts, dtype=torch.int32)[:, None]
                 + torch.arange(c, dtype=torch.int32))
    valid = torch.arange(c)[None] < torch.tensor(n_tok)[:, None]
    qg = q.reshape(b, c, kv, g, hd).permute(0, 2, 1, 3, 4).contiguous()
    return q, qg, kp, vp, table, positions, valid


# (case, scenario, window, kv_splits)
PAGED_CASES = [
    # recurrentgemma-9b's tick cut small: g 16, C 32 (512 rows, 8 row
    # tiles), a window under which slot 0's rows at 120-127 see no key of
    # the last split (the -1e30 junk), and a split beyond every frontier
    ("hd256-like prefill, junk", dict(g=16, hd=32, kv=1, c=32, ps=16,
                                      p_log=10, starts=(120, 0, 64, 0),
                                      n_tok=(32, 32, 9, 0)), 48, 3),
    ("prefill, no window", dict(g=16, hd=32, kv=1, c=32, ps=16, p_log=10,
                                starts=(120, 0, 64, 0),
                                n_tok=(32, 32, 9, 0)), None, 1),
    ("65 rows", dict(g=13, hd=16, c=5, ps=16, p_log=7, starts=(0, 9, 30, 0),
                     n_tok=(5, 1, 3, 0)), None, 2),
    ("96 rows, ps 12", dict(g=3, hd=16, c=32, ps=12, p_log=10,
                            starts=(40, 0, 80, 0), n_tok=(32, 20, 32, 0)),
     24, 3),
    ("ps 48, window", dict(g=3, hd=16, c=5, ps=48, p_log=7,
                           starts=(0, 9, 100, 0), n_tok=(5, 1, 3, 0)), 8, 7),
    ("ps 12, empty splits", dict(g=1, hd=16, c=5, ps=12, p_log=7,
                                 starts=(0, 9, 30, 0), n_tok=(5, 1, 3, 0)),
     None, 7),
    ("decode g 16", dict(g=16, hd=64, kv=1, c=1, ps=16, p_log=12,
                         starts=(191, 17, 100, 0), n_tok=(1, 1, 1, 0)), 64, 4),
    ("decode g 3", dict(g=3, hd=64, c=1, ps=16, p_log=15,
                        starts=(231, 17, 100, 0), n_tok=(1, 1, 1, 0)), None, 1),
    ("hd 256", dict(g=4, hd=256, kv=1, c=4, ps=16, p_log=6,
                    starts=(70, 3, 30, 0), n_tok=(4, 4, 2, 0)), 40, 2),
]


def _valid_close(got, want, valid, name):
    """allclose at PAGED_ATOL on the valid rows (chip_smoke.py's check)."""
    rows = valid[:, None, None, :, None]
    mask = (rows[..., None] if got.dim() == 6 else rows).expand_as(got)
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got[mask], want[mask], atol=PAGED_ATOL,
                               rtol=PAGED_ATOL, msg=name)


@pytest.mark.parametrize("case,scen,window,splits", PAGED_CASES,
                         ids=[c[0] for c in PAGED_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_paged_emulation_matches_plain(case, scen, window, splits, dtype):
    q, qg, kp, vp, table, positions, valid = _paged_scenario(
        len(case), dtype=dtype, **scen)
    got = emulate_paged(qg, kp, vp, table, positions, window=window,
                        kv_splits=splits)
    want = paged_ref.paged_flash_fwd_ref(qg, kp, vp, table, positions,
                                         positions[:, 0], window=window,
                                         kv_splits=splits)
    for name, x, y in zip(("acc", "m", "l"), got, want):
        _valid_close(x, y, valid, name)
    out = paged_ref.combine_splits(*got).permute(0, 2, 1, 3, 4).reshape(q.shape)
    plain = paged_ref.paged_attention_ref(q, kp, vp, table, positions,
                                          window=window)
    assert (out[valid] - plain[valid]).abs().max() <= PAGED_ATOL


def test_paged_emulation_carries_the_junk():
    """The windowed prefill case holds valid rows whose split has only
    masked keys of running pages: there m stays -1e30 and l counts those
    keys (exp(0) each), as in the reference."""
    case, scen, window, splits = PAGED_CASES[0]
    _, qg, kp, vp, table, positions, valid = _paged_scenario(len(case), **scen)
    _, m, l = emulate_paged(qg, kp, vp, table, positions, window=window,
                            kv_splits=splits)
    junk = (m == NEG_INF) & (l > 0) & valid[:, None, None, :, None]
    assert junk.any()
    _, m_ref, l_ref = paged_ref.paged_flash_fwd_ref(
        qg, kp, vp, table, positions, positions[:, 0], window=window,
        kv_splits=splits)
    assert torch.equal(l[junk], l_ref[junk])


@pytest.mark.parametrize("case,scen,window,splits",
                         [PAGED_CASES[i] for i in (0, 3, 4, 6)],
                         ids=[PAGED_CASES[i][0] for i in (0, 3, 4, 6)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_emulation_matches_pallas(case, scen, window, splits, dtype):
    """Against the JAX Pallas kernel in interpret mode, as the JAX
    package's own tests run it."""
    _, qg, kp, vp, table, positions, valid = _paged_scenario(
        len(case), dtype=dtype, **scen)
    got = emulate_paged(qg, kp, vp, table, positions, window=window,
                        kv_splits=splits)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = paged_flash_fwd(
        jnp.asarray(qg.numpy()), jnp.asarray(kp.float().numpy(), jdt),
        jnp.asarray(vp.float().numpy(), jdt), jnp.asarray(table.numpy()),
        jnp.asarray(positions.numpy()), jnp.asarray(positions[:, 0].numpy()),
        window=window, kv_splits=splits, interpret=True)
    for name, x, y in zip(("acc", "m", "l"), got, want):
        _valid_close(x, torch.tensor(jax_numpy(y)), valid, name)


@pytest.mark.parametrize("hd", [32, 64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_bf16_rounding_of_q_misses_the_tolerance(hd, seed):
    """q rounded once to bf16 (2^-9 relative) puts the outputs about 1e-3
    from the plain version, ten times PAGED_ATOL; its hi / lo split is
    within it."""
    q, qg, kp, vp, table, positions, valid = _paged_scenario(
        seed, g=4, hd=hd, kv=1, c=8, ps=16, p_log=4, starts=(20, 0, 0),
        n_tok=(8, 8, 0))
    plain = paged_ref.paged_attention_ref(q, kp, vp, table, positions)

    def err(q_parts):
        part = emulate_paged(qg, kp, vp, table, positions, q_parts=q_parts)
        out = paged_ref.combine_splits(*part).permute(0, 2, 1, 3, 4)
        return float((out.reshape(q.shape)[valid] - plain[valid]).abs().max())

    assert err(1) > PAGED_ATOL
    assert err(2) <= PAGED_ATOL


# -- flash ---------------------------------------------------------------

# (b, s, h, kv, hd): a ragged S under 64-row tiles, GQA, smollm-360m's
# heads, and hd 256's 32-key kv tiles
FLASH_SHAPES = [(1, 100, 4, 1, 16), (2, 64, 4, 2, 32), (1, 130, 6, 2, 64),
                (1, 96, 2, 1, 256)]


def _flash_inputs(seed, b, s, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=(n, s, hd)),
                              dtype=torch.float32).to(dtype)
                 for n in (b * h, b * kv, b * kv))


@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_emulation_matches_plain(b, s, h, kv, hd, causal, window, dtype):
    q, k, v = _flash_inputs(s + hd, b, s, h, kv, hd, dtype)
    got = emulate_flash(q, k, v, causal=causal, window=window)
    want = flash_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    atol, rtol = FLASH_TOL[dtype]
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, 40)])
def test_flash_emulation_matches_pallas(causal, window):
    """f32, S 128 under bq = bk = 32 on the JAX side, against the Pallas
    kernel in interpret mode."""
    b, s, h, kv, hd = 1, 128, 4, 2, 32
    q, k, v = _flash_inputs(7, b, s, h, kv, hd, torch.float32)
    got = emulate_flash(q, k, v, causal=causal, window=window)

    def model_layout(t, heads):
        return jnp.asarray(t.reshape(b, heads, s, hd).transpose(1, 2).numpy())

    want = jflash.flash_attention(model_layout(q, h), model_layout(k, kv),
                                  model_layout(v, kv), causal=causal,
                                  window=window, bq=32, bk=32, interpret=True)
    want = torch.tensor(np.asarray(want)).transpose(1, 2).reshape(b * h, s, hd)
    atol, rtol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
