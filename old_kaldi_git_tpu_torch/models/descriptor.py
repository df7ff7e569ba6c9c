"""nnet3 Descriptor language: parser and evaluator over tensors.

Counterpart of old_kaldi_git_tpu/models/descriptor.py (reference
src/nnet3/nnet-descriptor.{h,cc}), the expressions that wire nnet3 nodes
together:

  Append(d, ...)        concatenate on the feature axis
  Offset(d, o)          time shift by o frames
  Sum(d, ...)           elementwise sum
  Scale(s, d)           scalar multiply
  Const(value, dim)     constant vector
  ReplaceIndex(d, t, n) the value at absolute frame n for every frame
  Round(d, m)           frame index rounded down to a multiple of m
  IfDefined(d)          d where defined, zeros elsewhere
  Failover(d1, d2)      d1 where defined, else d2
  <name>                a named node's output
  <int>                 shorthand for Offset(<default input>, int)

A descriptor evaluates in one pass over [B, T, D] tensors.  Offset(x, o) at
frame t is defined iff 0 <= t+o < T; its value is clamped to the edge frame
(the splice convention), and the strict mask (numpy, it depends on T and the
offsets alone) lets IfDefined / Failover zero or fall back where the
reference's compiler would have pruned the dependency.  Every time gather is
a slice of an edge-padded copy or an `expand`, never an indexed gather, so
the backward pass sums by reductions and repeats itself bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from old_kaldi_git_tpu_torch.utils.log import KaldiError


@dataclasses.dataclass(frozen=True)
class Desc:
    """Descriptor node: op in {ref, offset, append, sum, scale, const,
    replace_index, round, if_defined, failover}; children per op."""

    op: str
    args: Tuple = ()        # child Desc nodes
    name: str = ""          # ref
    num: float = 0.0        # offset amount / scale / const value / round mod
    dim: int = 0            # const


def _tokenize(s: str) -> List[str]:
    out: List[str] = []
    cur = ""
    for ch in s:
        if ch in "(),":
            if cur.strip():
                out.append(cur.strip())
            cur = ""
            out.append(ch)
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


_FUNCS = {"Append", "Offset", "Sum", "Scale", "Const", "ReplaceIndex",
          "Round", "IfDefined", "Failover"}


def parse_descriptor(text: str, default_input: str = "__prev__") -> Desc:
    """Parse a descriptor expression.  Bare integers are shorthand for
    Offset(default_input, n) (the xconfig Append(-1,0,1) convention)."""
    toks = _tokenize(text)
    pos = 0

    def peek() -> Optional[str]:
        return toks[pos] if pos < len(toks) else None

    def take(expect: Optional[str] = None) -> str:
        nonlocal pos
        if pos >= len(toks):
            raise KaldiError(f"descriptor: unexpected end in {text!r}")
        tok = toks[pos]
        pos += 1
        if expect is not None and tok != expect:
            raise KaldiError(f"descriptor: expected {expect!r} got {tok!r} in {text!r}")
        return tok

    def scalar() -> str:
        tok = take()
        if tok in "(),":
            raise KaldiError(f"descriptor: expected a number, got {tok!r} in {text!r}")
        return tok

    def parse_expr() -> Desc:
        tok = take()
        if tok in _FUNCS:
            take("(")
            if tok == "Const":
                v = scalar()
                take(",")
                dim = int(scalar())
                take(")")
                if dim < 1:
                    raise KaldiError(f"Const dim must be >=1 in {text!r}")
                return Desc("const", num=float(v), dim=dim)
            if tok == "Scale":
                s = scalar()
                take(",")
                d1 = parse_expr()
                take(")")
                return Desc("scale", (d1,), num=float(s))
            if tok == "Offset":
                d1 = parse_expr()
                take(",")
                n = int(scalar())
                take(")")
                return Desc("offset", (d1,), num=float(n))
            if tok == "ReplaceIndex":
                d1 = parse_expr()
                take(",")
                tv = scalar()
                take(",")
                n = int(scalar())
                take(")")
                if tv not in ("t", "x"):
                    raise KaldiError(f"ReplaceIndex variable must be t or x in {text!r}")
                return Desc("replace_index", (d1,), num=float(n))
            if tok == "Round":
                d1 = parse_expr()
                take(",")
                m = int(scalar())
                take(")")
                if m < 1:
                    raise KaldiError(f"Round modulus must be >=1 in {text!r}")
                return Desc("round", (d1,), num=float(m))
            # Append / Sum / IfDefined / Failover: expression list
            args: List[Desc] = [parse_expr()]
            while peek() == ",":
                take(",")
                args.append(parse_expr())
            take(")")
            if tok == "Append":
                return Desc("append", tuple(args))
            if tok == "Sum":
                if len(args) < 2:
                    raise KaldiError(f"Sum needs >=2 args in {text!r}")
                return Desc("sum", tuple(args))
            if tok == "IfDefined":
                if len(args) != 1:
                    raise KaldiError(f"IfDefined(d) malformed in {text!r}")
                return Desc("if_defined", tuple(args))
            if len(args) != 2:
                raise KaldiError(f"Failover(d1, d2) malformed in {text!r}")
            return Desc("failover", tuple(args))
        try:
            off = int(tok)
            return Desc("offset", (Desc("ref", name=default_input),), num=float(off))
        except ValueError:
            pass
        return Desc("ref", name=tok)

    d = parse_expr()
    if pos != len(toks):
        raise KaldiError(f"descriptor: trailing tokens in {text!r}")
    return d


def referenced_names(d: Desc) -> List[str]:
    out: List[str] = []
    if d.op == "ref":
        out.append(d.name)
    for a in d.args:
        out.extend(referenced_names(a))
    return out


def offset_range(d: Desc) -> Tuple[int, int]:
    """(min, max) total time offset reachable through this descriptor, the
    layer's share of the left / right receptive field.  Round(d, m) can
    reach m−1 frames back; ReplaceIndex is an absolute index, counted 0."""
    if d.op in ("ref", "const", "replace_index"):
        return 0, 0
    if d.op == "offset":
        lo, hi = offset_range(d.args[0])
        return lo + int(d.num), hi + int(d.num)
    if d.op == "round":
        lo, hi = offset_range(d.args[0])
        return lo - (int(d.num) - 1), hi
    los, his = zip(*(offset_range(a) for a in d.args)) if d.args else ((0,), (0,))
    return min(los), max(his)


def descriptor_dim(d: Desc, dims: Mapping[str, int]) -> int:
    """The feature width a descriptor evaluates to, from its nodes' widths
    (what a layer's affine needs before any tensor exists)."""
    if d.op == "ref":
        if d.name not in dims:
            raise KaldiError(f"descriptor references unknown node {d.name!r} "
                             f"(have {sorted(dims)})")
        return int(dims[d.name])
    if d.op == "const":
        return d.dim
    if d.op == "append":
        return sum(descriptor_dim(a, dims) for a in d.args)
    widths = {descriptor_dim(a, dims) for a in d.args}
    if len(widths) != 1:
        what = "Sum" if d.op == "sum" else "Failover branches" if d.op == "failover" else d.op
        raise KaldiError(f"{what} over mismatched dims {sorted(widths)}")
    return widths.pop()


def _shift(v: torch.Tensor, o: int) -> torch.Tensor:
    """Frame t takes frame clip(t + o, 0, T − 1): a slice of the sequence
    padded with copies of its edge frames."""
    if o == 0:
        return v
    T = v.shape[-2]
    k = min(abs(o), T)
    if o > 0:
        pad = v[..., -1:, :].expand(*v.shape[:-2], k, v.shape[-1])
        return torch.cat([v[..., k:, :], pad], dim=-2)
    pad = v[..., :1, :].expand(*v.shape[:-2], k, v.shape[-1])
    return torch.cat([pad, v[..., : T - k, :]], dim=-2)


def _mask(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(m)).to(v.device)[:, None]


def eval_descriptor(d: Desc, env: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, np.ndarray]:
    """Evaluate over the [B, T, D] tensors of `env` → (value [B, T, D'],
    defined [T] numpy bool)."""
    if d.op == "ref":
        if d.name not in env:
            raise KaldiError(f"descriptor references unknown node {d.name!r} "
                             f"(have {sorted(env)})")
        v = env[d.name]
        return v, np.ones((v.shape[-2],), bool)
    if d.op == "const":
        ref = next(iter(env.values()))
        B, T = ref.shape[0], ref.shape[1]
        return (torch.full((B, T, d.dim), d.num, dtype=ref.dtype, device=ref.device),
                np.ones((T,), bool))
    if d.op == "offset":
        v, m = eval_descriptor(d.args[0], env)
        T = v.shape[-2]
        o = int(d.num)
        shifted = np.arange(T) + o
        idx = np.clip(shifted, 0, T - 1)
        return _shift(v, o), m[idx] & (shifted >= 0) & (shifted < T)
    if d.op == "round":
        v, m = eval_descriptor(d.args[0], env)
        T, r = v.shape[-2], int(d.num)
        kept = v[..., ::r, :]
        rep = kept[..., :, None, :].expand(*kept.shape[:-1], r, kept.shape[-1])
        out = rep.reshape(*kept.shape[:-2], kept.shape[-2] * r, kept.shape[-1])
        return out[..., :T, :], m[(np.arange(T) // r) * r]
    if d.op == "replace_index":
        v, _ = eval_descriptor(d.args[0], env)
        T = v.shape[-2]
        n = int(np.clip(int(d.num), 0, T - 1))
        return v[..., n: n + 1, :].expand(v.shape), np.ones((T,), bool)
    if d.op == "scale":
        v, m = eval_descriptor(d.args[0], env)
        return d.num * v, m
    if d.op == "sum":
        vs, ms = zip(*(eval_descriptor(a, env) for a in d.args))
        dims = {v.shape[-1] for v in vs}
        if len(dims) != 1:
            raise KaldiError(f"Sum over mismatched dims {sorted(dims)}")
        tot = vs[0]
        for v in vs[1:]:
            tot = tot + v
        return tot, np.logical_and.reduce(ms)
    if d.op == "append":
        vs, ms = zip(*(eval_descriptor(a, env) for a in d.args))
        return torch.cat(vs, dim=-1), np.logical_and.reduce(ms)
    if d.op == "if_defined":
        v, m = eval_descriptor(d.args[0], env)
        return (torch.where(_mask(m, v), v, torch.zeros_like(v)),
                np.ones((v.shape[-2],), bool))
    if d.op == "failover":
        v1, m1 = eval_descriptor(d.args[0], env)
        v2, m2 = eval_descriptor(d.args[1], env)
        if v1.shape[-1] != v2.shape[-1]:
            raise KaldiError(f"Failover branches disagree on dim: {v1.shape[-1]} vs "
                             f"{v2.shape[-1]}")
        return torch.where(_mask(m1, v1), v1, v2), m1 | m2
    raise KaldiError(f"unknown descriptor op {d.op!r}")
