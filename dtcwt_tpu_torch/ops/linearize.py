"""Gradients of the transforms on the card (``dtcwt_tpu.ops.linearize``).

The CUDA kernels fill fresh tensors through ctypes, so autograd cannot see
through a launch.  Every DTCWT forward and inverse is *linear* in its
operand, so its vector-Jacobian product is the transpose of the map and
needs no residual.  :func:`linear_vjp` wraps a transform's level chain in
a ``torch.autograd.Function`` whose forward runs the chain (the kernels
on a CUDA tensor; grad mode is off there, so ``_build.check_no_grad``
passes) and whose backward runs, chosen from the configuration alone
before the forward runs:

* the explicit adjoint (:mod:`adjoint`), on the kernels too, where the
  transform's filters, shapes and dtype allow it; or
* ``torch.func.vjp`` of *plain*, the same chain with every level call
  bound to its ``*_reference`` plain version, on the same device: the
  JAX package's ``linear_transpose`` of its XLA evaluation.

The sharded transforms (``parallel/_grid.py``) run each filter pass
over their shard grid as one such Function, whose operand and result are
grids of tensors; the glue between the passes stays PyTorch operators.
Nothing falls back when a kernel fails, and no global switch chooses the
route.  The kernels' outputs carry no graph, so a second-order backward
(``create_graph=True``) through the explicit route raises in the
kernels' ``check_no_grad``; the plain route differentiates again.
"""

from __future__ import annotations

import torch

from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

__all__ = ["linear_vjp", "dispatch", "entry", "needs_vjp"]


def entry(module, name: str, plain: bool):
    """``module.name``, or with *plain* its plain version
    ``module.name_reference``, looked up at call time."""
    return getattr(module, name + "_reference" if plain else name)


def needs_vjp(operand) -> bool:
    """Whether a transform takes :func:`linear_vjp` for *operand* (a
    tensor, a pyramid or a grid): grad mode is on and a leaf on a CUDA
    device requires grad.  The plain path on the CPU keeps PyTorch's own
    autograd."""
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.is_cuda for t in _tree(operand)[0])


class _Grid(tuple):
    """The spec of a grid: per row, per shard, None for a tensor or the
    length of a tuple of tensors."""


def _tree(obj):
    """``(leaves, spec)`` of a tensor, :class:`Pyramid`,
    :class:`PlanePyramid` or grid (a list of rows, each a list of tensors
    or of tuples of tensors: the shards of ``parallel/_grid.py``): its
    tensors in a fixed order (``None`` entries left out) and its
    structure alone, which :func:`_fill` fills with as many new tensors.
    The spec holds no tensor, so an autograd node that keeps it keeps no
    operand or result alive."""
    if isinstance(obj, torch.Tensor):
        return [obj], None
    if isinstance(obj, list):
        one = lambda t: isinstance(t, torch.Tensor)
        return ([x for row in obj for t in row for x in ((t,) if one(t)
                                                          else t)],
                _Grid(tuple(None if one(t) else len(t) for t in row)
                      for row in obj))
    plane = isinstance(obj, PlanePyramid)
    groups = ([(obj.lowpass,), obj.highpasses_re, obj.highpasses_im]
              if plane else [(obj.lowpass,), obj.highpasses])
    groups.append(() if obj.scales is None else obj.scales)
    spec = (obj.kind if plane else None,
            tuple(tuple(x is not None for x in g) for g in groups),
            obj.scales is not None)
    return [x for g in groups for x in g if x is not None], spec


def _fill(spec, new):
    """The structure *spec* of :func:`_tree` with the tensors *new*."""
    if spec is None:
        return new[0]
    it = iter(new)
    if isinstance(spec, _Grid):
        return [[next(it) if n is None else tuple(next(it) for _ in range(n))
                 for n in row] for row in spec]
    kind, present, has_scales = spec
    parts = [tuple(next(it) if p else None for p in g) for g in present]
    scales = parts[-1] if has_scales else None
    if kind is not None:
        return PlanePyramid(parts[0][0], parts[1], parts[2], scales,
                            kind=kind)
    return Pyramid(parts[0][0], parts[1], scales)


class _Route:
    """One application's maps and structures: the operand's spec and its
    leaves' (shape, dtype, device), the result's spec once the forward has
    run.  It holds no tensor."""

    def __init__(self, impl, adjoint, plain, leaves, spec_in):
        self.impl, self.adjoint, self.plain = impl, adjoint, plain
        self.spec_in = spec_in
        self.specs = [(t.shape, t.dtype, t.device) for t in leaves]
        self.spec_out = None

    def plain_vjp(self, cots):
        """``torch.func.vjp`` of the plain chain at zero (the map is
        linear, so the point does not matter)."""
        def flat(*leaves):
            return tuple(_tree(self.plain(_fill(self.spec_in, leaves)))[0])
        zeros = [torch.zeros(s, dtype=d, device=v) for s, d, v in self.specs]
        return torch.func.vjp(flat, *zeros)[1](tuple(cots))


class _LinearMap(torch.autograd.Function):
    """The level chain over the operand's flat leaves."""

    @staticmethod
    def forward(ctx, route, *leaves):
        ctx.route = route
        out, route.spec_out = _tree(route.impl(_fill(route.spec_in, leaves)))
        return tuple(out)

    @staticmethod
    def backward(ctx, *cots):
        route = ctx.route
        # a loss through .conj() hands in cotangents with the lazy
        # conjugate bit, which the kernels' complex views refuse
        cots = [c.resolve_conj().contiguous() for c in cots]
        if route.adjoint is not None:
            grads = _tree(route.adjoint(_fill(route.spec_out, cots)))[0]
        else:
            grads = route.plain_vjp(cots)
        return (None,) + tuple(g if need else None for g, need in
                               zip(grads, ctx.needs_input_grad[1:]))


def linear_vjp(impl, adjoint, plain):
    """Wrap the linear map *impl* (operand -> result, each a tensor,
    :class:`Pyramid`, :class:`PlanePyramid` or grid) so that autograd
    differentiates it: the backward runs *adjoint* (result gradient ->
    operand gradient, the same structures) where it is not None, and
    otherwise ``torch.func.vjp`` of *plain*, a map equal to *impl* built
    from differentiable operations.  Returns the wrapped map."""
    def apply(operand):
        leaves, spec = _tree(operand)
        route = _Route(impl, adjoint, plain, leaves, spec)
        out = _LinearMap.apply(route, *leaves)
        return _fill(route.spec_out, out)
    return apply


def dispatch(chain, operand, adjoint=None):
    """``chain(operand, False)``, a transform's level chain (``chain(x,
    True)`` is the same chain on the plain versions).  Where
    :func:`needs_vjp` of *operand* holds it runs as one :func:`linear_vjp`
    Function, whose backward is ``adjoint()`` (a call that gives the
    explicit adjoint, or None) where it is not None."""
    if not needs_vjp(operand):
        return chain(operand, False)
    return linear_vjp(lambda x: chain(x, False), adjoint and adjoint(),
                      lambda x: chain(x, True))(operand)
