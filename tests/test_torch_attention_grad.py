"""Port parity for attention's backward (kernel 6b's plain version and the
autograd function around kernel 6), on the CPU.

``FlashAttentionFn`` (kernel 6 with its row log-sum-exp L forward, kernel 6b
backward; their plain versions here) is held against torch autograd of an
out-of-place reference, against ``jax.grad`` of the JAX package's
``attend_full`` (the function JAX trains through) on the same numpy inputs,
and its L against ``logsumexp`` of the masked scores.  Kernel 6b's plan in
plain PyTorch: the query-tile marks of its dK / dV pass
(``query_tile_marks``) against a brute-force pair mask, and the rule that
splits a kv-head's query heads across blocks on small grids
(``backward_head_splits``).

Tolerances (f32): 1e-5 relative to each gradient's largest value against
torch autograd and JAX (the same products in another order: S-term and
G·S-term sums); L to 1e-5 absolute.  Cases: causal, a window, a softcap,
non-causal, G > 1, empty key slots, several head dims.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec as JAttnSpec
from repro.models import attention as jattn
from repro_torch.configs.base import AttnSpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import no_backward
from repro_torch.models import attention as tattn
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REL = 1e-5

# name -> (B, S, H, Hkv, dh, spec kwargs, empty key slots)
CASES = {
    "causal": (2, 24, 4, 4, 16, {}, False),
    "gqa_g4": (2, 20, 8, 2, 32, {}, False),
    "window": (2, 32, 4, 2, 16, dict(kind="local", window=7), False),
    "softcap": (2, 24, 4, 2, 16, dict(logit_softcap=5.0), False),
    "noncausal": (2, 16, 4, 4, 16, dict(kind="cross", causal=False, use_rope=False), False),
    "empty_slots": (2, 24, 6, 2, 8, {}, True),
}


def inputs(B, S, H, Hkv, dh, empty, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, dout = f(B, S, H, dh), f(B, S, Hkv, dh), f(B, S, Hkv, dh), f(B, S, H, dh)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos = pos.copy()
    if empty:  # empty slots, never slot 0, so every causal row keeps a valid key
        k_pos[:, np.arange(S) % 5 == 3] = -1
    return q, k, v, dout, pos, k_pos


def spec_kw(spec: AttnSpec) -> dict:
    return dict(causal=spec.causal, window=spec.window if spec.kind == "local" else 0,
                softcap=spec.logit_softcap)


def leaves(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad and x.dtype == np.float32) for x in xs]


def assert_grads(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= REL, f"{what} {name}: {err:.3e} of the largest"


def torch_reference(q, k, v, q_pos, k_pos, spec, scale):
    """The model's ``_sdpa`` with the window-causal mask: out-of-place torch
    ops, differentiable by autograd."""
    mask = tattn._window_causal_mask(q_pos, k_pos, spec.window if spec.kind == "local" else 0,
                                     spec.causal)
    return tattn._sdpa(q, k, v, mask, scale, spec.logit_softcap)


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_torch_autograd_and_jax_grad(name):
    B, S, H, Hkv, dh, kw, empty = CASES[name]
    spec, jspec = AttnSpec(**kw), JAttnSpec(**kw)
    q, k, v, dout, q_pos, k_pos = inputs(B, S, H, Hkv, dh, empty, seed=len(name))
    scale = dh ** -0.5
    tq, tk, tv, tqp, tkp = leaves(q, k, v, q_pos, k_pos, grad=True)
    out = tattn.attend_full(tq, tk, tv, tqp, tkp, spec, scale)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    rq, rk, rv = leaves(q, k, v, grad=True)
    ref = torch_reference(rq, rk, rv, torch.from_numpy(q_pos), torch.from_numpy(k_pos), spec, scale)
    assert_grads(got, torch.autograd.grad(ref, (rq, rk, rv), torch.from_numpy(dout)), name)

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.attend_full(q_, k_, v_, q_pos, k_pos, jspec, scale) * dout)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    assert_grads([g.numpy() for g in got], jgrads, f"{name} vs jax.grad")


@pytest.mark.parametrize("name", ["causal", "window", "softcap", "noncausal", "empty_slots"])
def test_plain_backward_given_the_forward_matches_autograd(name):
    """``flash_attention_backward_plain`` called directly with the plain
    forward's out and L (what the kernel wrapper receives)."""
    B, S, H, Hkv, dh, kw, empty = CASES[name]
    spec = AttnSpec(**kw)
    q, k, v, dout, q_pos, k_pos = inputs(B, S, H, Hkv, dh, empty, seed=3)
    scale = 0.3
    tq, tk, tv, tqp, tkp, tdo = leaves(q, k, v, q_pos, k_pos, dout)
    out, lse = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, scale=scale, return_lse=True,
                                        **spec_kw(spec))
    got = fa.flash_attention_backward_plain(tq, tk, tv, tqp, tkp, out, tdo, lse, scale=scale,
                                            **spec_kw(spec))
    rq, rk, rv = leaves(q, k, v, grad=True)
    ref = torch_reference(rq, rk, rv, tqp, tkp, spec, scale)
    assert_grads(got, torch.autograd.grad(ref, (rq, rk, rv), tdo), name)


@pytest.mark.parametrize("name", ["causal", "window", "softcap", "empty_slots"])
def test_forward_lse_is_the_masked_logsumexp(name):
    B, S, H, Hkv, dh, kw, empty = CASES[name]
    spec = AttnSpec(**kw)
    q, k, v, _, q_pos, k_pos = inputs(B, S, H, Hkv, dh, empty, seed=4)
    tq, tk, tv, tqp, tkp = leaves(q, k, v, q_pos, k_pos)
    out, lse = fa.flash_attention_plain(tq, tk, tv, tqp, tkp, scale=0.25, return_lse=True,
                                        **spec_kw(spec))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    z = torch.einsum("bshd,bthd->bhst", tq, tk.repeat_interleave(H // Hkv, dim=2)) * 0.25
    if spec.logit_softcap > 0:
        z = spec.logit_softcap * torch.tanh(z / spec.logit_softcap)
    mask = tattn._window_causal_mask(tqp, tkp, spec.window if spec.kind == "local" else 0,
                                     spec.causal)[:, 0]  # [B, 1, S, T]
    want = torch.logsumexp(z.masked_fill(~mask, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(out, fa.flash_attention_plain(tq, tk, tv, tqp, tkp, scale=0.25,
                                                             **spec_kw(spec)), atol=0, rtol=0)


def test_row_without_valid_key_gets_zero_gradients():
    """Non-causal over keys that are all empty in batch row 1: its outputs
    are 0, its L is +inf, and its q, k and v get zero gradients."""
    q, k, v, dout, q_pos, k_pos = inputs(2, 12, 4, 2, 8, False, seed=5)
    k_pos[1] = -1
    tq, tk, tv, tqp, tkp = leaves(q, k, v, q_pos, k_pos, grad=True)
    out = fa.flash_attention_gqa(tq, tk, tv, tqp, tkp, scale=0.3, causal=False)
    assert out[1].abs().max() == 0
    _, lse = fa.flash_attention_plain(tq.detach(), tk.detach(), tv.detach(), tqp, tkp, scale=0.3,
                                      causal=False, return_lse=True)
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for g in (dq, dk, dv):
        assert g[1].abs().max() == 0 and g[0].abs().max() > 0


def test_serving_path_builds_no_graph():
    """Without grad, or with inputs that do not require it, kernel 6's
    wrapper takes its serving form: no autograd node, and the same values
    as the differentiable path."""
    q, k, v, _, q_pos, k_pos = inputs(1, 10, 4, 2, 8, False, seed=6)
    tq, tk, tv, tqp, tkp = leaves(q, k, v, q_pos, k_pos)
    plain = fa.flash_attention_gqa(tq, tk, tv, tqp, tkp, scale=0.3)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention_gqa(tq.requires_grad_(), tk, tv, tqp, tkp, scale=0.3).grad_fn is None
    diff = fa.flash_attention_gqa(tq, tk, tv, tqp, tkp, scale=0.3)
    assert diff.grad_fn is not None
    torch.testing.assert_close(diff.detach(), plain, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_guard_of_kernels_without_a_backward(dtype):
    """``refuse_grad``, which kernels 3, 5 and 7-9 call on the card before
    they launch: it raises under grad for an input that requires it, and
    passes under ``no_grad`` or for inputs that do not."""
    x = torch.zeros(3, dtype=dtype)
    no_backward.refuse_grad("k", no_backward.EXPERT_KERNELS, x, None)
    w = torch.zeros(3, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward.*MoQ weights are post-training"):
        no_backward.refuse_grad("expert_mlp_quant", no_backward.EXPERT_KERNELS, x, w)
    with torch.no_grad():
        no_backward.refuse_grad("expert_mlp_quant", no_backward.EXPERT_KERNELS, x, w)


def pair_mask(q_pos, k_pos, causal, window):
    """[S, T] validity of every (query, key) pair, the masks of ``Mask``."""
    qp, kp = q_pos.long()[:, None], k_pos.long()[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return ok


@pytest.mark.parametrize("layout", ["aligned", "shifted", "random"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37), (False, 0), (False, 100)])
def test_query_tile_marks_never_skip_a_valid_pair_and_mark_full_exactly(layout, causal, window):
    """For every key tile of a row with empty slots (-1): a query tile
    holding a valid pair with the key tile is live, and it is full only
    where every pair of its queries with the tile's 64 key slots is valid
    (a slot past T or empty is not).  Positions: a training row (queries
    and keys at 0 .. S - 1), queries after a cached prefix, and random."""
    rng = np.random.default_rng([len(layout), int(causal), window])
    tile = fa.BWD_TILE
    S, T = 300, 300 if layout == "aligned" else 333
    if layout == "aligned":
        q_pos, k_pos = np.arange(S), np.arange(T)
    elif layout == "shifted":
        q_pos, k_pos = np.arange(T - S, T), np.arange(T)
    else:
        q_pos, k_pos = rng.integers(0, 400, S), rng.integers(0, 400, T)
    k_pos = np.where((rng.random(T) < 0.1) & (np.arange(T) >= tile), -1, k_pos)  # tile 0 whole
    k_pos[2 * tile:3 * tile] = -1  # a tile with no valid key marks nothing
    q_pos, k_pos = torch.from_numpy(q_pos.astype(np.int32)), torch.from_numpy(k_pos.astype(np.int32))
    ok = pair_mask(q_pos, k_pos, causal, window)
    n_q = -(-S // tile)
    seen_full = seen_skip = 0
    for j in range(-(-T // tile)):
        keys = k_pos[j * tile:(j + 1) * tile]
        live, full = fa.query_tile_marks(q_pos, keys, causal=causal, window=window)
        assert live.shape == full.shape == (n_q,)
        for t in range(n_q):
            pairs = ok[t * tile:(t + 1) * tile, j * tile:(j + 1) * tile]
            if pairs.any():
                assert live[t], (j, t)
            every = bool(pairs.all()) and pairs.shape[1] == tile
            assert bool(full[t]) <= every, (j, t)  # full only where every pair is valid
            if not bool(keys.lt(0).any()) and keys.numel() == tile and every:
                assert full[t], (j, t)  # exact for a tile without empty slots
            seen_full += int(full[t])
            seen_skip += int(~live[t])
        if not bool((keys >= 0).any()):
            assert not live.any() and not full.any()
    if layout == "aligned" and causal:
        assert seen_skip > 0 and (seen_full > 0 or window > 0)  # the walk skips, spares masks


def test_query_tile_marks_start_a_causal_walk_at_the_diagonal():
    """A causal training row: key tile j is seen by query tiles j .. n - 1
    only, and full below the diagonal tile."""
    S = 5 * fa.BWD_TILE
    pos = torch.arange(S, dtype=torch.int32)
    for j in range(5):
        live, full = fa.query_tile_marks(pos, pos[j * 64:(j + 1) * 64])
        assert live.tolist() == [t >= j for t in range(5)]
        assert full.tolist() == [t > j for t in range(5)]


@pytest.mark.parametrize("T,Hkv,B,G,n_sm,want", [
    (512, 16, 8, 1, 132, 1),    # nlg-350m-prmoe's step: 1024 blocks, no split
    (1024, 8, 2, 4, 132, 1),    # 256 blocks already fill the card
    (512, 4, 2, 2, 132, 2),     # 64 blocks: G = 2 halves each kv-head
    (512, 1, 1, 4, 132, 4),     # 8 blocks, G = 4: one head a block
    (2048, 1, 1, 10, 132, 5),   # recurrentgemma's 10 heads over 1: 32 x 5 >= 132
    (256, 4, 2, 1, 132, 1),     # G = 1: nothing to split
    (64, 1, 1, 16, 132, 16),    # one key tile: every head a block
])
def test_backward_head_splits_fill_the_card_where_g_allows(T, Hkv, B, G, n_sm, want):
    splits = fa.backward_head_splits(T, Hkv, B, G, n_sm)
    assert splits == want
    base = -(-T // fa.BWD_TILE) * Hkv * B
    assert 1 <= splits <= G
    assert base * splits >= n_sm or splits == G  # the card is filled where G allows
    if base >= n_sm:
        assert splits == 1  # no split where the grid already fills it
    else:
        assert base * (splits - 1) < n_sm  # no more splits than it takes
