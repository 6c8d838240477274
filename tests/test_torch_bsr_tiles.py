"""A CPU rehearsal of the arithmetic of ``csrc/bsr_tile.cuh``.

The tile forward spmm (BlockCSR and palette) and the SDDMM run their
products on the tensor cores in bf16 with f32 sums, while their plain
versions compute in f32 and the kernels are held to them at 2e-4 + 1e-4
relative (the SDDMM at 2e-4 * max(1, M / 32), since its sums run over M).
The kernels cannot run here, so this file emulates each kernel's operand
scheme and order of sums in PyTorch and holds the emulation to the plain
versions and to the JAX package's Pallas kernels (interpret mode), at the
tolerances the card's checks use:

* forward: per resident block, 128 columns at a time, the products of the
  parts (bf16 x as it is, f32 x as three bf16 parts hi, mid, lo; the f32
  store and the palette values as three parts, code 0 exact zero; of two
  split operands, the products whose part orders sum to at most 2) summed
  from zero and added to the accumulator in f32;
* SDDMM: per slot, chunks of 64 rows of M with the same parts, each
  chunk's sum added in f32, over the M ranges the wrapper splits M into,
  combined in order;
* spmm_t: per block-column, jobs of 128 / br resident blocks (their dY
  slabs side by side, their blocks stacked: two blocks a k-step of 16 at br
  8, 16 / br below), with the same parts, each job's sum added in f32; the
  wrapper splits only the outputs (64-column chunks, row tiles), so no
  output has partial sums to combine;
* the decode kernel (f32 FMAs, no tensor cores): each warp's resident
  blocks in turn, lane l's columns 4 l .. 4 l + 3 (+ 128 ...), the lanes'
  partial sums added by the transposing butterfly, then the block-row's
  warps in order.

A product of two bf16 values is exact in f32, so the emulation is faithful
up to the order of the f32 sums. A single bf16 rounding of the f32 store
misses the tolerance, and so does a hi + lo pair (the first chip run of
that scheme missed it too), which is why the kernels split an f32 operand
into three parts. The wrappers' shape rules (which forward kernel by M,
the SDDMM's split of M, spmm_t's row tiles, the decode kernel's warps per
block-row, the tile kernels' 16-byte staging and padded head dims) are
plain Python and are checked here too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_sddmm import ops as jsddmm
from repro.kernels.bsr_spmm import ops as jops
from repro.sparse.compress import quantize_bcsr as jax_quantize_bcsr
from repro.sparse.formats import dense_to_bcsr as jax_dense_to_bcsr
from repro_torch.kernels import _tiles
from repro_torch.kernels.bsr_sddmm import ops as sddmm
from repro_torch.kernels.bsr_spmm import ops, ref
from repro_torch.sparse.formats import PaletteBCSR
from torch_parity import block_sparse, port_format

ATOL, RTOL = 2e-4, 1e-4              # chip_smoke.py and the GPU tests
K_SLAB = 128                         # columns of a staged slab
CHUNK = 64                           # SDDMM rows of M per staged chunk
SMS = 132                            # an H100 SXM's SMs


def split(x: torch.Tensor, parts: int = 3) -> list:
    """f32 ``x`` as ``parts`` bf16 parts (each the rounding of what the
    earlier ones leave), widened to f32; a bf16 operand has one part."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    out, rest = [], x.float()
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def products(a_parts, b_parts, fn):
    """Sum in f32 of fn(a_i, b_j) over the parts with i + j below the
    larger part count (all of them beside a one-part operand)."""
    order = max(len(a_parts), len(b_parts))
    terms = [fn(a, b) for i, a in enumerate(a_parts)
             for j, b in enumerate(b_parts) if i + j < order]
    return sum(terms[1:], terms[0])


def _blocks(w):
    """(n_slots, br, bc) values of the store, f32 for the f32 store and the
    palette values (split in three), bf16 for a bf16 store (one part)."""
    if isinstance(w, PaletteBCSR):
        return w.dequantize().data.float()
    return w.data


def emulate_fwd(x: torch.Tensor, w, store_parts: int = 3) -> torch.Tensor:
    """The tile forward's arithmetic: Y (M, N) f32. ``store_parts`` 1 or 2
    round an f32 store once or split it into hi + lo instead of three."""
    m, k = x.shape
    n = w.shape[0]
    br, bc = w.block
    data = _blocks(w)
    xp = torch.nn.functional.pad(x, (0, w.block_grid[1] * bc - k))
    x_parts = split(xp)
    y = torch.zeros(m, w.block_grid[0] * br)
    for o in range(w.block_grid[0]):
        acc = torch.zeros(m, br)
        for j in range(int(w.gather_nnz[o])):
            c, s = int(w.gather_idx[o, j]), int(w.gather_blk[o, j])
            b_parts = split(data[s], store_parts)
            t = torch.zeros(m, br)
            for kc in range(0, bc, K_SLAB):
                cols = slice(c * bc + kc, c * bc + min(kc + K_SLAB, bc))
                t = t + products(
                    [p[:, cols] for p in x_parts],
                    [p[:, kc:kc + K_SLAB] for p in b_parts],
                    lambda a, b: a @ b.T)
            acc = acc + t
        y[:, o * br:(o + 1) * br] = acc
    return y[:, :n]


def emulate_sddmm(x: torch.Tensor, dy: torch.Tensor, w, sms=SMS):
    """The SDDMM's arithmetic: (n_slots, br, bc) f32, invalid slots zero,
    over the M ranges of ``sddmm.m_split`` combined in order."""
    m = x.shape[0]
    br, bc = w.block
    n_slots = w.data.shape[0]
    xp = torch.nn.functional.pad(x, (0, w.block_grid[1] * bc - x.shape[1]))
    yp = torch.nn.functional.pad(dy, (0, w.block_grid[0] * br - dy.shape[1]))
    x_parts, y_parts = split(xp), split(yp)
    n_split = sddmm.m_split(m, n_slots, w.block, sms)
    rows_per = -(-(-(-m // n_split)) // CHUNK) * CHUNK
    out = torch.zeros(n_split, n_slots, br, bc)
    for c in range(w.block_grid[1]):
        for j in range(int(w.gather_t_nnz[c])):
            r, s = int(w.gather_t_idx[c, j]), int(w.gather_t_blk[c, j])
            xs = [p[:, c * bc:(c + 1) * bc] for p in x_parts]
            ys = [p[:, r * br:(r + 1) * br] for p in y_parts]
            for z in range(n_split):
                acc = torch.zeros(bc, br)
                r0, r1 = z * rows_per, min(m, (z + 1) * rows_per)
                for m0 in range(r0, r1, CHUNK):
                    rs = slice(m0, min(m0 + CHUNK, r1))
                    acc = acc + products([p[rs] for p in xs],
                                         [p[rs] for p in ys],
                                         lambda a, b: a.T @ b)
                out[z, s] = acc.T
    total = out[0]
    for z in range(1, n_split):
        total = total + out[z]
    _, _, valid = sddmm.slot_coordinates(w)
    return total * valid[:, None, None]


def emulate_spmm_t(dy: torch.Tensor, w) -> torch.Tensor:
    """spmm_t's arithmetic: dX (M, K) f32. Each block-column's resident
    blocks in jobs of 128 / br (128 summed entries): the job's dY slabs side
    by side times its blocks stacked, over the parts, summed from zero and
    added to the column's accumulator in f32."""
    m = dy.shape[0]
    br, bc = w.block
    r_grid, c_grid = w.block_grid
    yp = torch.nn.functional.pad(dy, (0, r_grid * br - dy.shape[1]))
    y_parts = split(yp)
    per_job = K_SLAB // br
    out = torch.zeros(m, c_grid * bc)
    for c in range(c_grid):
        n_j = int(w.gather_t_nnz[c])
        acc = torch.zeros(m, bc)
        for j0 in range(0, n_j, per_job):
            js = range(j0, min(j0 + per_job, n_j))
            rows = [int(w.gather_t_idx[c, j]) for j in js]
            a = [torch.cat([p[:, r * br:(r + 1) * br] for r in rows], 1)
                 for p in y_parts]
            b = split(torch.cat([w.data[int(w.gather_t_blk[c, j])] for j in js]))
            acc = acc + products(a, b, lambda u, v: u @ v)
        out[:, c * bc:(c + 1) * bc] = acc
    return out[:, :w.shape[1]]


LANES = 32


def emulate_decode(x: torch.Tensor, w) -> torch.Tensor:
    """The decode kernel's order of sums: Y (M, N) f32. Warp jw of a
    block-row takes its resident blocks j = jw, jw + J, ... in turn (J =
    ``ops.decode_warps(jmax)``); lane l adds x * w over its columns 4 l ..
    4 l + 3 (then + 128, ...); the butterfly adds lanes l and l + 16, then
    l + 8, ... down to one; the warps are added in the order of jw."""
    m, k = x.shape
    br, bc = w.block
    r_grid, c_grid = w.block_grid
    data = _blocks(w).float()
    xp = torch.nn.functional.pad(x.float(), (0, c_grid * bc - k))
    n_warps = ops.decode_warps(w.gather_idx.shape[1])
    lane = torch.arange(LANES)
    y = torch.zeros(m, r_grid * br)
    for o in range(r_grid):
        total = None
        for jw in range(n_warps):
            part = torch.zeros(LANES, m, br)
            for j in range(jw, int(w.gather_nnz[o]), n_warps):
                c, s = int(w.gather_idx[o, j]), int(w.gather_blk[o, j])
                for col0 in range(0, bc, 4 * LANES):
                    for e in range(4):
                        cols = col0 + 4 * lane + e
                        ok = cols < bc
                        cols = cols.clamp(max=bc - 1)
                        xv = xp[:, c * bc + cols] * ok      # (m, lanes)
                        wv = data[s][:, cols] * ok          # (br, lanes)
                        part = part + torch.einsum("ml,rl->lmr", xv, wv)
            h = LANES // 2
            while h >= 1:
                part = part[:h] + part[h:2 * h]
                h //= 2
            total = part[0] if total is None else total + part[0]
        y[:, o * br:(o + 1) * br] = total
    return y[:, :w.shape[0]]


SHAPES = [(64, 128, (8, 128)), (96, 160, (32, 32)), (128, 320, (16, 64)),
          (40, 300, (8, 256))]


def _weight(rng, n, k, block, density, store=torch.float32):
    w = block_sparse(rng, n, k, block, density)
    tm = port_format(jax_dense_to_bcsr(w, block))
    return dataclasses.replace(tm, data=tm.data.to(store)), w


@pytest.mark.parametrize("n,k,block", SHAPES)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_tile_fwd_emulation_matches_plain_and_pallas(n, k, block, x_dtype,
                                                     store):
    rng = np.random.default_rng(31)
    w, wd = _weight(rng, n, k, block, 0.5, store)
    xj = jnp.asarray(rng.normal(size=(24, k)), getattr(jnp, x_dtype))
    x = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    got = emulate_fwd(x, w)
    torch.testing.assert_close(got, ref.spmm_fwd_ref(x, w), atol=ATOL,
                               rtol=RTOL)
    if store == torch.float32:
        want = np.asarray(jops.spmm(xj, jax_dense_to_bcsr(wd, block), bm=8),
                          np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,k,block", SHAPES[:3])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_tile_fwd_palette_emulation_matches_plain_and_pallas(n, k, block,
                                                             bits, x_dtype):
    rng = np.random.default_rng(32)
    jq = jax_quantize_bcsr(jax_dense_to_bcsr(
        block_sparse(rng, n, k, block, 0.5), block), bits)
    q = port_format(jq)
    assert float(q.palette[0]) == 0.0       # code 0 is exact zero
    xj = jnp.asarray(rng.normal(size=(24, k)), getattr(jnp, x_dtype))
    x = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    got = emulate_fwd(x, q)
    torch.testing.assert_close(got, ref.spmm_palette_fwd_ref(x, q),
                               atol=ATOL, rtol=RTOL)
    want = np.asarray(jops.spmm_palette(xj, jq, bm=8), np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("store_parts", [1, 2])
def test_one_bf16_rounding_of_the_f32_store_misses_the_tolerance(store_parts):
    """bf16 x and an f32 store, as the recurrentgemma-9b engine runs, over
    a block-row of 2,560 O(1) products (the GPU tests' (960, 2560) shape at
    density 1). Rounding the store once to bf16 (2^-9 relative), or even
    splitting it into hi + lo (2^-18), puts outputs near zero past 2e-4 +
    1e-4 relative; its three parts hold."""
    rng = np.random.default_rng(33)
    wd = block_sparse(rng, 64, 2560, (8, 128), 1.0)
    w = port_format(jax_dense_to_bcsr(wd, (8, 128)))
    x = torch.tensor(rng.normal(size=(256, 2560)), dtype=torch.bfloat16)
    want = ref.spmm_fwd_ref(x, w)
    torch.testing.assert_close(emulate_fwd(x, w), want, atol=ATOL, rtol=RTOL)
    coarse = emulate_fwd(x, w, store_parts=store_parts)
    excess = ((coarse - want).abs() - (ATOL + RTOL * want.abs())).max()
    assert float(excess) > 0


@pytest.mark.parametrize("n,k,block,density", [
    (64, 128, (8, 128), 0.5), (96, 160, (32, 32), 0.6),
    (512, 256, (8, 128), 0.9), (100, 70, (8, 64), 0.5), (64, 96, (16, 16), 0.3)])
@pytest.mark.parametrize("m", [33, 200, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_emulation_matches_plain_and_pallas(n, k, block, density, m,
                                                  dtype):
    rng = np.random.default_rng(34)
    wd = block_sparse(rng, n, k, block, density)
    jm = jax_dense_to_bcsr(wd, block)
    w = port_format(jm)
    xj = jnp.asarray(rng.normal(size=(m, k)), getattr(jnp, dtype))
    dyj = jnp.asarray(rng.normal(size=(m, n)), getattr(jnp, dtype))
    x = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    dy = torch.tensor(np.asarray(dyj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = emulate_sddmm(x, dy, w)
    tol = dict(atol=ATOL * max(1, m / 32), rtol=RTOL)
    torch.testing.assert_close(got, sddmm.bsr_weight_grad_ref(x, dy, w), **tol)
    want = np.asarray(jsddmm.bsr_weight_grad(xj, dyj, jm, bm=8), np.float32)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_pick_kernel_threshold():
    assert ops.DECODE_MAX_M == 16
    assert [ops.pick_kernel(m) for m in (1, 4, 16, 17, 256, 512)] == \
        ["decode"] * 3 + ["tile"] * 3


@pytest.mark.parametrize("hd,offset", [
    (64, 0),                  # smollm-360m: taken as it is
    (256, 0),                 # recurrentgemma-9b
    (72, 0),                  # a multiple of 8: no padding
    (36, 0),                  # padded to 40 with zero columns
    (64, 1),                  # a view one element off a 16-byte boundary
])
def test_tile_ready_pads_and_aligns(hd, offset):
    """The attention wrappers' inputs as the tile core takes them: head dim
    a multiple of 8 with zero columns after the real ones, start on a
    16-byte boundary, values unchanged; an input that needs neither is not
    copied."""
    base = torch.randn(3 * 4 * hd + offset, dtype=torch.float32)
    t = base[offset:].view(3, 4, hd)
    hd_t = _tiles.tile_hd(hd)
    assert hd_t % 8 == 0 and hd <= hd_t < hd + 8
    got = _tiles.tile_ready(t, hd_t)
    assert got.shape == (3, 4, hd_t) and got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :hd], t)
    assert not got[..., hd:].any()
    assert (got.data_ptr() == t.data_ptr()) == (hd_t == hd and offset == 0)
    assert _tiles.aligned16(got, hd_t) == 1
    assert _tiles.aligned16(t, hd) == int(hd % 4 == 0 and offset == 0)


@pytest.mark.parametrize("m,n_slots,block,want", [
    (512, 97, (8, 128), 8),           # smollm-360m wq: 25 blocks -> 200
    (512, 257, (8, 128), 4),          # mlp.wi: 65 blocks -> 260
    (512, 2000, (8, 128), 1),         # enough slots
    (64, 97, (8, 128), 1),            # one chunk of M
    (512, 97, (32, 32), 2),           # 4 warps per slot at br 32
])
def test_sddmm_m_split(m, n_slots, block, want):
    assert sddmm.m_split(m, n_slots, block, SMS) == want


@pytest.mark.parametrize("n,k,block", SHAPES)
@pytest.mark.parametrize("m", [1, 33, 512])
@pytest.mark.parametrize("dy_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_spmm_t_emulation_matches_plain_and_pallas(n, k, block, m, dy_dtype,
                                                   store):
    rng = np.random.default_rng(35)
    w, wd = _weight(rng, n, k, block, 0.5, store)
    dyj = jnp.asarray(rng.normal(size=(m, n)), getattr(jnp, dy_dtype))
    dy = torch.tensor(np.asarray(dyj.astype(jnp.float32))).to(
        getattr(torch, dy_dtype))
    got = emulate_spmm_t(dy, w)
    torch.testing.assert_close(got, ref.spmm_bwd_ref(dy, w), atol=ATOL,
                               rtol=RTOL)
    if store == torch.float32:
        want = np.asarray(jops.spmm_t(dyj, jax_dense_to_bcsr(wd, block),
                                      bm=min(m, 128) if m % 8 == 0 else 8,
                                      interpret=True), np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,k,block", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_decode_emulation_matches_plain_and_pallas(n, k, block, m, x_dtype,
                                                   store):
    rng = np.random.default_rng(36)
    w, wd = _weight(rng, n, k, block, 0.5, store)
    xj = jnp.asarray(rng.normal(size=(m, k)), getattr(jnp, x_dtype))
    x = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    got = emulate_decode(x, w)
    torch.testing.assert_close(got, ref.spmm_fwd_ref(x, w), atol=ATOL,
                               rtol=RTOL)
    if store == torch.float32:
        want = np.asarray(jops.spmm(xj, jax_dense_to_bcsr(wd, block), bm=8),
                          np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,k,block", SHAPES[:3])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 16])
def test_decode_palette_emulation_matches_plain_and_pallas(n, k, block, bits,
                                                           m):
    rng = np.random.default_rng(37)
    jq = jax_quantize_bcsr(jax_dense_to_bcsr(
        block_sparse(rng, n, k, block, 0.5), block), bits)
    q = port_format(jq)
    xj = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    x = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = emulate_decode(x, q)
    torch.testing.assert_close(got, ref.spmm_palette_fwd_ref(x, q),
                               atol=ATOL, rtol=RTOL)
    want = np.asarray(jops.spmm_palette(xj, jq, bm=8), np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m,k_blocks,bc,dy_f32,want", [
    (512, 8, 128, False, 32),   # smollm-360m K = 960: 128 blocks of 64 rows
    (512, 20, 128, False, 64),  # K = 2560: 320 blocks of 64 rows
    (512, 32, 128, False, 64),  # recurrentgemma-9b's K = 4096
    (4096, 8, 128, False, 64),  # many rows
    (1, 20, 128, False, 32),    # one row
    (512, 8, 256, False, 64),   # two 64-column chunks a block-column more
    (512, 20, 128, True, 32),   # f32 dY: always 32
    (4096, 8, 128, True, 32),
])
def test_spmm_t_rows(m, k_blocks, bc, dy_f32, want):
    assert ops.spmm_t_rows(m, k_blocks, bc, SMS, dy_f32) == want


@pytest.mark.parametrize("jmax,want", [(0, 1), (1, 1), (2, 2), (3, 4),
                                       (4, 4), (5, 8), (8, 8), (20, 8)])
def test_decode_warps(jmax, want):
    assert ops.decode_warps(jmax) == want
