"""Post-training weight-only quantization of a parameter tree
(``repro/quant/ptq.py``; MoQ, DeepSpeed-MoE §4).

A policy picks leaves by their key path in the :class:`ParamTree`:

  * ``experts``: the routed expert matrices (``moe/{wi,wg,wo}``) only;
  * ``experts_attn``: plus the attention projections;
  * ``all``: every matmul weight (dense FFNs, the residual expert, unembed).
    Routers, norms and embeddings always stay full precision.

Each leaf is quantized over the contraction axes of the product it feeds,
so scales are per output channel (or per ``group_size`` inputs).  Leaves
that are not quantized are shared with the input tree, not copied.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.configs.base import QuantConfig
from repro_torch.quant.qarrays import QuantizedArray

_EXPERT_KEYS = ("wi", "wg", "wo")
_ATTN_QKV_AXES = (-3,)  # wq/wk/wv: [D, H, dh] contract D
_ATTN_WO_AXES = (-3, -2)  # wo: [H, dh, D] contract (H, dh)
_MATMUL_AXES = (-2,)  # [.., Din, Dout] contract Din
POLICIES = ("experts", "experts_attn", "all")


def _rule_for(path_names: List[str], policy: str) -> Optional[Tuple[int, ...]]:
    """Contraction axes of a quantizable leaf under ``policy``, or None."""
    leaf = path_names[-1]
    inside = set(path_names[:-1])
    if "moe" in inside and leaf in _EXPERT_KEYS and "residual" not in inside:
        return _MATMUL_AXES  # stacked [.., E, Din, Dout] expert matrices
    if policy == "experts":
        return None
    if ("attn" in inside or "cross" in inside) and leaf in ("wq", "wk", "wv", "wo"):
        return _ATTN_WO_AXES if leaf == "wo" else _ATTN_QKV_AXES
    if policy != "all":
        return None
    if ("ffn" in inside or "residual" in inside) and leaf in _EXPERT_KEYS:
        return _MATMUL_AXES
    if leaf in ("unembed", "frontend_proj"):
        return _MATMUL_AXES
    return None


def leaf_quant_args(path_names: List[str], qcfg: QuantConfig) -> Optional[dict]:
    """``QuantizedArray.quantize`` keywords for a leaf, or None to keep it
    full precision.  Group-wise scales apply along one contraction axis only;
    the attention out-projection (two) falls back to per output channel."""
    axes = _rule_for(path_names, qcfg.policy)
    if axes is None:
        return None
    return dict(bits=qcfg.bits, group_size=qcfg.group_size if len(axes) == 1 else 0,
                reduce_axes=axes)


def quantize_params(params, qcfg: QuantConfig):
    """A new :class:`ParamTree` with the policy's matmul weights quantized
    (stacked leaves one ``[D, F]`` slice at a time); every other leaf is the
    input's own tensor."""
    from repro_torch.models.model import ParamTree

    if qcfg.policy not in POLICIES:
        raise ValueError(f"unknown quant policy {qcfg.policy!r}")

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            names = path + [k]
            if isinstance(v, ParamTree):
                out[k] = visit(v, names)
                continue
            kw = None if isinstance(v, QuantizedArray) else leaf_quant_args(names, qcfg)
            out[k] = v if kw is None else QuantizedArray.quantize(v, **kw)
        return ParamTree(out)

    return visit(params, [])


def dequantize_params(params):
    """Every ``QuantizedArray`` leaf back to full precision."""
    from repro_torch.models.model import ParamTree

    def visit(tree):
        return ParamTree({k: visit(v) if isinstance(v, ParamTree)
                          else v.dequantize() if isinstance(v, QuantizedArray) else v
                          for k, v in tree.items()})

    return visit(params)


def prepare_params_for_serving(cfg, params):
    """Where serving and quantization meet, as in the JAX package: the
    identity, unless expert-parallel serving will run (``moe_impl`` an EP
    impl under an ambient mesh), whose schedules take plain expert weights:
    then the quantized routed-expert leaves (directly under ``moe``; the
    shared expert's ``moe/residual`` keeps its own) are dequantized once,
    here, and kernels 3 and 5 do not run.  Every other quantized leaf stays
    quantized."""
    from repro_torch.models.model import ParamTree
    from repro_torch.parallel.params import EXPERT_KEYS
    from repro_torch.parallel.sharding import get_mesh

    if getattr(cfg, "moe_impl", None) not in ("ep", "ep_serve", "ep_grouped") or get_mesh() is None:
        return params

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, ParamTree):
                out[k] = visit(v, path + [k])
            elif isinstance(v, QuantizedArray) and path[-1:] == ["moe"] and k in EXPERT_KEYS:
                out[k] = v.dequantize()
            else:
                out[k] = v
        return ParamTree(out)

    return visit(params, [])


def _leaves(tree, path=()):
    from repro_torch.models.model import ParamTree

    for k, v in tree.items():
        if isinstance(v, ParamTree):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def quantized_leaf_paths(params) -> List[str]:
    """'/'-joined key paths of the quantized leaves."""
    return ["/".join(p) for p, v in _leaves(params) if isinstance(v, QuantizedArray)]


def tree_bytes(params, *, only_quantized: bool = False) -> int:
    """Total parameter bytes; a ``QuantizedArray`` counts packed ints plus
    scales."""
    total = 0
    for _, v in _leaves(params):
        if isinstance(v, QuantizedArray):
            total += v.nbytes
        elif not only_quantized:
            total += v.numel() * v.element_size()
    return total
