"""The tensor-core backward of the SwiGLU expert MLP (kernels 2b and 4b,
``csrc/grouped_mlp_bwd.cu``) on the CPU: the plain mirror of the tables its
wgmma passes walk (``backward_tiles_plain``, ``backward_plan_plain``,
``backward_pass_c_tiles``) over the JAX package's grouped layout, capacity
fills and tile maps no dispatch makes; and the gradients its schedule
computes (``backward_by_plan``: packed rows, row-pass windows, pass C's
chunked contraction) against the plain backwards and ``jax.vjp`` of the JAX
package's ``experts_ffn`` / ``grouped_mlp_ref``, with NaN in every dead row.

Tolerances: tables, windows and tiles are integers, compared exactly.  The
schedule sums in f64 as the plain backwards do, in other groupings: against
them rtol 1e-6 / atol 1e-6 (both f64, the plain backwards round a, du and
dg to f32 from another grouping, which moves a rounded value by an f32
ulp); against JAX's f32 sums rtol 1e-5 and an atol of 1e-6 of each
tensor's largest value, as ``test_torch_expert_grad.py``'s autograd
comparison (f32 sums of up to 48 rows of values up to about 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch_grouped as jdg
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.kernels import expert_mlp_grouped as jgk
from repro_torch.kernels import expert_mlp as k2
from repro_torch.kernels import expert_mlp_grouped as gk

TILE = gk.TILE
CHUNK, WIN = gk.BWD_CHUNK, gk.BWD_WINDOW


def jax_grouped(T, E, K, seed, skew=None):
    """(te, rows_used) of the JAX package's grouped layout of a random
    routing: ``skew`` puts most tokens on one expert, ``"empty"`` leaves
    experts 1 and 2 without a token."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if skew == "one":
        logits[:, 3] += 3.0
    if skew == "empty":
        logits[:, 1:3] = -1e9
    g = jgating.top_k_gating(jnp.asarray(logits), K, T * K)
    lay = jdg.grouped_layout(g, E)
    counts = np.asarray(lay.counts)
    rows_used = int(((counts + TILE - 1) // TILE * TILE).sum())
    return torch.tensor(np.array(lay.tile_expert)), torch.tensor([rows_used], dtype=torch.int32)


# name -> (E, tables): capacity fills (C = 160 at llama4's 2048 tokens over
# 16 experts; an expert past capacity, an empty one, one of 1 row) and
# grouped layouts from JAX (kimi-like top-8; skewed; empty experts), plus a
# tile map no dispatch makes (experts interleaved, dead tiles in between)
def case_tables(name):
    if name == "capacity_llama4":
        fill = torch.tensor(np.random.default_rng(0).integers(100, 170, 16), dtype=torch.int32)
        return 16, gk.backward_tiles_plain(16, fill=fill, C=160)
    if name == "capacity_edges":
        fill = torch.tensor([200, 0, 1, 8, 9, 64, 65, 191, 192, -3], dtype=torch.int32)
        return 10, gk.backward_tiles_plain(10, fill=fill, C=200)
    if name == "grouped_top8":
        te, used = jax_grouped(256, 32, 8, 1)
        return 32, gk.backward_tiles_plain(32, te=te, rows_used=used)
    if name == "grouped_skewed":
        te, used = jax_grouped(700, 8, 1, 2, "one")
        return 8, gk.backward_tiles_plain(8, te=te, rows_used=used)
    if name == "grouped_empty":
        te, used = jax_grouped(40, 6, 2, 3, "empty")
        return 6, gk.backward_tiles_plain(6, te=te, rows_used=used)
    te = torch.tensor([2, 0, 2, 1, 0, 2, 2, 0, 5, 5, 1, 3], dtype=torch.int32)  # "interleaved"
    return 6, gk.backward_tiles_plain(6, te=te, rows_used=torch.tensor([10 * TILE], dtype=torch.int32))


CASES = ["capacity_llama4", "capacity_edges", "grouped_top8", "grouped_skewed", "grouped_empty",
         "interleaved"]


@pytest.mark.parametrize("name", CASES)
def test_every_live_row_packed_once(name):
    """Each live row of the buffer is exactly one packed row, of its tile's
    expert, and every other packed row is empty (-1)."""
    E, (tile_e, tile_rows) = case_tables(name)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E)
    nt = tile_e.shape[0]
    live = [t * TILE + r for t in range(nt) for r in range(int(tile_rows[t]))]
    packed = plan.prow[plan.prow >= 0].tolist()
    assert sorted(packed) == live
    for e in range(E):
        rows = plan.prow[int(plan.poff[e]):int(plan.poff[e + 1])]
        assert all(int(tile_e[r // TILE]) == e for r in rows[rows >= 0].tolist())
    assert plan.prow.shape[0] == gk.backward_packed_rows(nt, E)
    assert int(plan.poff[-1]) <= plan.prow.shape[0]
    assert sorted(plan.order.tolist()) == [t for t in range(nt) if tile_rows[t] > 0]


@pytest.mark.parametrize("name", CASES)
def test_windows_tile_each_expert_once(name):
    """The row passes' windows cover each expert's packed rows once, in
    expert order, at most ``BWD_WINDOW`` rows each, within the grid bound."""
    E, (tile_e, tile_rows) = case_tables(name)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E)
    assert len(plan.windows) <= gk.backward_max_windows(tile_e.shape[0], E)
    assert [w[2] for w in plan.windows] == sorted(w[2] for w in plan.windows)
    for e in range(E):
        mine = [(a, b) for a, b, x in plan.windows if x == e]
        covered = [r for a, b in mine for r in range(a, b)]
        assert covered == list(range(int(plan.poff[e]), int(plan.poff[e + 1])))
        assert all(0 < b - a <= WIN for a, b in mine)


@pytest.mark.parametrize("name", CASES)
def test_pass_c_reads_no_dead_row(name):
    """Pass C contracts over each expert's packed rows in chunks of
    ``BWD_CHUNK``: whole chunks, inside [poff[e], poff[e + 1]), each row a
    live row of expert e or an empty one (0 in the packed buffers): no dead
    tile, row past fill or tile past rows_used is ever read."""
    E, (tile_e, tile_rows) = case_tables(name)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E)
    dead = {t * TILE + r for t in range(tile_e.shape[0]) for r in range(int(tile_rows[t]), TILE)}
    for e in range(E):
        q0, q1 = int(plan.poff[e]), int(plan.poff[e + 1])
        assert (q1 - q0) % CHUNK == 0
        read = plan.prow[q0:q1].tolist()
        assert not dead & set(read)
        assert all(r < 0 or int(tile_e[r // TILE]) == e for r in read)


@pytest.mark.parametrize("name", ["capacity_edges", "grouped_empty", "interleaved"])
def test_empty_expert_gets_no_block_and_zero_chunks(name):
    """An expert with no live row has no packed row, no window, and pass C
    tiles with no chunk (they store zeros)."""
    E, (tile_e, tile_rows) = case_tables(name)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E)
    empty = [e for e in range(E) if not any(tile_rows[t] > 0 and tile_e[t] == e
                                                for t in range(tile_e.shape[0]))]
    assert empty
    for e in empty:
        assert plan.poff[e] == plan.poff[e + 1]
        assert all(w[2] != e for w in plan.windows)
    tiles = gk.backward_pass_c_tiles(E, 256, 384, 128)
    assert len(tiles) == E * 2 * 3 and len(set(tiles)) == len(tiles)
    assert {t[0] for t in tiles} == set(range(E))


@pytest.mark.parametrize("M,N,bn", [(1024, 2048, 128), (2048, 1024, 256), (256, 128, 256),
                                    (384, 640, 256)])
def test_pass_c_tiles_cover_each_gradient_once(M, N, bn):
    """Pass C's output tiles (128 rows x ``bn`` columns, columns fastest)
    cover every element of each expert's [M, N] gradient once; a last
    tile past N (640 = 2 x 256 + 128) is cut at N."""
    E = 3
    cover = np.zeros((E, M, N), np.int8)
    for e, m, n in gk.backward_pass_c_tiles(E, M, N, bn):
        cover[e, m:m + 128, n:n + bn] += 1
    assert (cover == 1).all()


def test_weight_crossings_per_expert():
    """Windows per expert (each a crossing of the expert's weight tiles
    from L2 in passes A and B) at the widths the source's note states:
    llama4-maverick's capacity buffer (C = 160) one per expert, kimi-k2's
    grouped top-8 at 1024 tokens over 32 experts (about 256 rows an
    expert) two."""
    E, (tile_e, tile_rows) = case_tables("capacity_llama4")
    plan = gk.backward_plan_plain(tile_e, tile_rows, E)
    assert [sum(w[2] == e for w in plan.windows) for e in range(E)] == [1] * E
    te, used = jax_grouped(1024, 32, 8, 4)
    tile_e, tile_rows = gk.backward_tiles_plain(32, te=te, rows_used=used)
    plan = gk.backward_plan_plain(tile_e, tile_rows, 32)
    per = [sum(w[2] == e for w in plan.windows) for e in range(32)]
    assert set(per) <= {1, 2} and sum(per) >= 28


E_S, D_S, F_S = 4, 32, 48


def weights(seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32))
    return w(E_S, D_S, F_S), w(E_S, D_S, F_S), w(E_S, F_S, D_S)


def schedule_close(got, want, rtol=1e-6, atol=1e-6):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w.double(), rtol=rtol, atol=atol)


def jax_close(got, want):
    """Against JAX's f32 sums: rtol 1e-5, atol 1e-6 of the largest value."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max(initial=0.0))))


@pytest.mark.parametrize("fill", [[16, 11, 0, 5], [24, 1, 9, 24], [0, 0, 3, 0]])
def test_capacity_schedule_matches_plain_backward(fill):
    """Kernel 2b's plan over the capacity buffer (C = 24, NaN in every row
    past fill) computes the plain backward's gradients."""
    C = 24
    wi, wg, wo = weights(5)
    rng = np.random.default_rng(6)
    xe = torch.from_numpy(rng.standard_normal((E_S, C, D_S)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((E_S, C, D_S)).astype(np.float32))
    fill_t = torch.tensor(fill, dtype=torch.int32)
    for e, n in enumerate(fill):
        xe[e, n:] = float("nan")
        dy[e, n:] = float("nan")
    tile_e, tile_rows = gk.backward_tiles_plain(E_S, fill=fill_t, C=C)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E_S)
    dx, dwi, dwg, dwo = gk.backward_by_plan(xe.reshape(-1, D_S), dy.reshape(-1, D_S), wi, wg, wo, plan)
    clean = lambda a: torch.nan_to_num(a, nan=0.0)
    want = k2.expert_mlp_backward_plain(clean(xe), wi, wg, wo, clean(dy), fill_t)
    schedule_close((dx.reshape(E_S, C, D_S), dwi, dwg, dwo), want)


@pytest.mark.parametrize("seed", [7, 8])
def test_grouped_schedule_matches_jax_vjp(seed):
    """Kernel 4b's plan over JAX's grouped layout of a top-2 routing, NaN in
    the trailing dead tiles, against ``jax.vjp`` of ``grouped_mlp_ref`` on
    the live tiles and the plain backward on the whole buffer."""
    te, used = jax_grouped(30, E_S, 2, seed)
    n_live = int(used) // TILE
    nt = te.shape[0]
    wi, wg, wo = weights(seed)
    rng = np.random.default_rng(seed + 1)
    xg = torch.from_numpy(rng.standard_normal((nt * TILE, D_S)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((nt * TILE, D_S)).astype(np.float32))
    xg[n_live * TILE:] = float("nan")
    dy[n_live * TILE:] = float("nan")
    tile_e, tile_rows = gk.backward_tiles_plain(E_S, te=te, rows_used=used)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E_S)
    got = gk.backward_by_plan(xg, dy, wi, wg, wo, plan)
    want = gk.grouped_mlp_backward_plain(xg, te, wi, wg, wo, dy, used)
    schedule_close(got, want)
    assert torch.count_nonzero(got[0][n_live * TILE:]) == 0
    live = slice(0, n_live * TILE)
    f = lambda x, a, b, c: jgk.grouped_mlp_ref(x, jnp.asarray(te[:n_live].numpy()), a, b, c)
    _, vjp = jax.vjp(f, xg[live].numpy(), wi.numpy(), wg.numpy(), wo.numpy())
    jwant = vjp(jnp.asarray(dy[live].numpy()))
    for g, w in zip((got[0][live], *got[1:]), jwant):
        jax_close(g, w)


def test_capacity_schedule_matches_jax_vjp():
    """Kernel 2b's plan against ``jax.vjp`` of the JAX package's
    ``experts_ffn`` (rows past fill zero, as the dispatch leaves them)."""
    C, fill = 16, [16, 11, 0, 5]
    wi, wg, wo = weights(9)
    rng = np.random.default_rng(10)
    xe = rng.standard_normal((E_S, C, D_S)).astype(np.float32)
    dy = rng.standard_normal((E_S, C, D_S)).astype(np.float32)
    for e, n in enumerate(fill):
        xe[e, n:] = 0.0
    f = lambda x, a, b, c: jmoe.experts_ffn({"wi": a, "wg": b, "wo": c}, x, "swiglu")
    _, vjp = jax.vjp(f, xe, wi.numpy(), wg.numpy(), wo.numpy())
    want = vjp(jnp.asarray(dy))
    fill_t = torch.tensor(fill, dtype=torch.int32)
    tile_e, tile_rows = gk.backward_tiles_plain(E_S, fill=fill_t, C=C)
    plan = gk.backward_plan_plain(tile_e, tile_rows, E_S)
    got = gk.backward_by_plan(torch.from_numpy(xe).reshape(-1, D_S),
                              torch.from_numpy(dy).reshape(-1, D_S), wi, wg, wo, plan)
    # JAX's dx covers rows past fill too (0 there only where dy is: the
    # plain backward and the kernel zero them); compare the live rows
    dx = got[0].reshape(E_S, C, D_S)
    for e, n in enumerate(fill):
        jax_close(dx[e, :n], np.asarray(want[0])[e, :n])
        assert torch.count_nonzero(dx[e, n:]) == 0
    for g, w in zip(got[1:], want[1:]):
        jax_close(g, w)
