"""The port's ``jax.lax.scan`` for the recurrent blocks (``ssm``).

``scan(step, carry, xs, consts=)`` runs ``step`` once a trip over dim 1
of ``xs`` (the sequence or chunk dim of (B, S, ...) inputs) and returns
``(final carry, per-trip outputs stacked along dim 1)`` as ``lax.scan``
does over dim 0.  ``step(carry, x, consts, prod)`` takes and returns
tuples of tensors: the carry, trip ``t``'s slice of each of ``xs``, the
trip's outputs.
``consts`` are the tensors every trip reads (their gradients summed over
the trips); ``prod(eq, a, b)`` is the step's every product, a
two-operand ``torch.einsum``.

* **Forward**: an eager loop.  A trip issues the step's ops and nothing
  else (values equal a plain loop's bit for bit); the trips' outputs are
  stacked once at the end.
* **Gradient** (``_Scan``, the counterpart of the scan's transpose): the
  forward keeps each trip's input carry and its products' outputs (the
  tensors the trip made: no copy); the backward runs the trips in
  reverse, each the VJP of one step from its saved carry: the step's
  elementwise terms are recomputed under autograd, its products are not
  (``_Product`` returns the saved output and issues the two ``bmm`` of
  autograd's own ``einsum`` backward).  So the products issued are
  those of autograd through the loop.
* **Counted**: when a dispatch mode on the stack has ``weighs_trips``
  set (``lm.launch.dryrun``'s rank counter), the forward and the
  backward each run ONE trip inside ``mode.repeat(n)``, which weighs
  everything it issues by the trip count ``n`` — the reference's
  ``hlo_analysis`` counts a while loop of known trip count as its body
  times the count.  Every trip issues the same ops whatever its index,
  so the weighted counts equal an unrolled trace's.  The tensors that
  the other trips would keep (their outputs until the stack, their
  saved carries and products, their input gradients) are allocated as
  stand-ins the counter does not count (``repeat(0)``), so a memory
  tracker sees the unrolled bytes.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


_UNWEIGHED = contextlib.nullcontext()


class _Trips:
    """The trips of one scan pass under the active dispatch modes:
    every trip, or — under a mode that weighs trips — trip 0 alone,
    weighed by ``length``."""

    def __init__(self, length: int, reverse: bool = False):
        self.length = length
        self.mode = next((m for m in reversed(
            _get_current_dispatch_mode_stack())
            if getattr(m, "weighs_trips", False)), None)
        if self.mode is not None:
            self.indices = [0]
        else:
            self.indices = (range(length - 1, -1, -1) if reverse
                            else range(length))

    def weigh(self):
        return (self.mode.repeat(self.length) if self.mode is not None
                else _UNWEIGHED)

    def stand_ins(self, ts):
        """Counted: one uncounted ``(length - 1, ...)`` tensor for each of
        ``ts`` (a trip's tensors), standing for the trips not run; else
        none."""
        if self.mode is None:
            return ()
        with self.mode.repeat(0):
            return tuple(t.new_empty((self.length - 1,) + tuple(t.shape))
                         for t in ts)

    def stack(self, per_trip, skip=frozenset()):
        """The stacks along dim 1 of one tuple of tensors a trip, and
        (counted: the trip run stands for every trip) the stand-ins of
        the other trips' tensors but those in ``skip`` (ids), for the
        caller to hold as long as it holds ``per_trip``."""
        cols = list(zip(*per_trip))
        if self.mode is None:
            return tuple(torch.stack(c, 1) for c in cols), ()
        stand_ins = self.stand_ins([c[0] for c in cols
                                    if id(c[0]) not in skip])
        return tuple(torch.stack(list(c) * self.length, 1)
                     for c in cols), stand_ins


class _Record:
    """A forward trip's ``prod``: ``torch.einsum``, each output kept."""

    def __init__(self):
        self.outs = []

    def __call__(self, eq, a, b):
        out = torch.einsum(eq, a, b)
        self.outs.append(out)
        return out


def _loop(step, carry, xs, consts, trips, prod, keep=None):
    """The forward trips: the final carry, the stacked outputs and the
    stand-ins of what ``keep`` keeps.  Given ``keep`` (``prod`` a
    ``_Record``), each trip's input carry and products' outputs are
    appended to it."""
    ys = []
    for t in trips.indices:
        if keep is not None:
            keep.append(carry)
        with trips.weigh():
            carry, y = step(carry, tuple(x.select(1, t) for x in xs),
                            consts, prod)
        ys.append(y)
        if keep is not None:
            keep[-1] += tuple(prod.outs)
            prod.outs.clear()
    kept = trips.stand_ins(keep[0]) if keep else ()
    # an output that is a kept product is stood in for already
    ys, _ = trips.stack(ys, {id(k) for k in keep[0]} if keep else ())
    return carry, ys, kept


def _bmm_form(eq, a, b):
    """``einsum(eq, a, b)`` as ``torch.einsum`` runs it: ``a`` as
    (batch, lo, sum), ``b`` as (batch, sum, ro) matrices, with the dims
    and sizes to map a (batch, lo, ro) result back."""
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    batch = [c for c in out if c in la and c in lb]
    lo = [c for c in out if c in la and c not in lb]
    ro = [c for c in out if c in lb and c not in la]
    su = [c for c in la if c in lb and c not in out]
    assert sorted(batch + lo + su) == sorted(la), eq
    assert sorted(batch + su + ro) == sorted(lb), eq
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))

    def mat(t, have, *groups):
        dims = [c for g in groups for c in g]
        return t.permute([have.index(c) for c in dims]).reshape(
            [math.prod(size[c] for c in g) for g in groups])

    return mat, (la, lb, out), (batch, lo, ro, su), size


def _unmat(m, dims, want, size):
    """A (batch, x, y) matrix over ``dims`` back to ``want``'s order."""
    t = m.reshape([size[c] for c in dims])
    return t.permute([dims.index(c) for c in want])


class _Product(torch.autograd.Function):
    """A product replayed in the backward's recompute: its saved output,
    with the VJP of autograd's ``einsum`` (two ``bmm``)."""

    @staticmethod
    def forward(ctx, out, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mat, (la, lb, out), (batch, lo, ro, su), size = _bmm_form(ctx.eq,
                                                                   a, b)
        gm = mat(g, out, batch, lo, ro)
        ga = gb = None
        if ctx.needs_input_grad[2]:
            ga = _unmat(torch.bmm(gm, mat(b, lb, batch, su, ro)
                                  .transpose(1, 2)), batch + lo + su, la, size)
        if ctx.needs_input_grad[3]:
            gb = _unmat(torch.bmm(mat(a, la, batch, lo, su).transpose(1, 2),
                                  gm), batch + su + ro, lb, size)
        return None, None, ga, gb


class _Replay:
    """A backward trip's ``prod``: the forward's outputs in call order."""

    def __init__(self, outs):
        self.outs = iter(outs)

    def __call__(self, eq, a, b):
        return _Product.apply(next(self.outs), eq, a, b)


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, step, n_carry, n_xs, *args):
        carry = args[:n_carry]
        xs = args[n_carry:n_carry + n_xs]
        consts = args[n_carry + n_xs:]
        trips = _Trips(xs[0].shape[1])
        kept = []
        final, ys, stand_ins = _loop(step, carry, xs, consts, trips,
                                     _Record(), kept)
        ctx.step, ctx.length = step, trips.length
        ctx.n = (n_carry, n_xs, len(consts), len(kept), len(kept[0]))
        # the stand-ins live as long as the saved trips they stand for
        ctx.save_for_backward(*xs, *consts, *(t for k in kept for t in k),
                              *stand_ins)
        return (*final, *ys)

    @staticmethod
    def backward(ctx, *grads):
        n_carry, n_xs, n_consts, n_kept, per_trip = ctx.n
        saved = ctx.saved_tensors
        xs = saved[:n_xs]
        consts = saved[n_xs:n_xs + n_consts]
        flat = saved[n_xs + n_consts:n_xs + n_consts + n_kept * per_trip]
        kept = [flat[i:i + per_trip] for i in range(0, len(flat), per_trip)]
        need = ctx.needs_input_grad[3:]
        need_x = need[n_carry:n_carry + n_xs]
        need_c = need[n_carry + n_xs:]
        gxs = []
        gconsts = [torch.zeros_like(c) if nd else None
                   for c, nd in zip(consts, need_c)]
        cd = tuple(c.detach().requires_grad_(nd)
                   for c, nd in zip(consts, need_c))
        gc = grads[:n_carry]
        g_ys = grads[n_carry:]
        trips = _Trips(ctx.length, reverse=True)
        for t in trips.indices:
            with trips.weigh():
                with torch.enable_grad():
                    c_in = tuple(c.detach().requires_grad_()
                                 for c in kept[t][:n_carry])
                    x_in = tuple(x.select(1, t).detach().requires_grad_(nd)
                                 for x, nd in zip(xs, need_x))
                    c_out, y_out = ctx.step(c_in, x_in, cd,
                                            _Replay(kept[t][n_carry:]))
                    wrt = c_in + tuple(x for x, nd in zip(x_in, need_x)
                                       if nd) \
                        + tuple(c for c, nd in zip(cd, need_c) if nd)
                    got = torch.autograd.grad(
                        c_out + y_out, wrt,
                        gc + tuple(g.select(1, t) for g in g_ys),
                        materialize_grads=True)
                gc, got = got[:n_carry], iter(got[n_carry:])
                gxs.append(tuple(next(got) for nd in need_x if nd))
                for i, nd in enumerate(need_c):
                    if nd:
                        gconsts[i] = gconsts[i] + next(got)
        # the trips ran in reverse; the stand-ins live until the return
        stacked, stand_ins = trips.stack(gxs[::-1])
        stacked = iter(stacked)
        g_xs = tuple(next(stacked) if nd else None for nd in need_x)
        g_init = tuple(g if nd else None
                       for g, nd in zip(gc, need[:n_carry]))
        return (None,) * 3 + g_init + g_xs + tuple(gconsts)


def scan(step, carry, xs, *, consts=()):
    """``lax.scan(step, carry, xs)`` over dim 1 of each of ``xs``:
    ``(final carry, per-trip outputs stacked along dim 1)``.  See the
    module docstring for ``step``'s form.  Where a gradient is wanted,
    through ``_Scan``; else a plain loop of the same trips."""
    carry, xs, consts = tuple(carry), tuple(xs), tuple(consts)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in carry + xs + consts):
        out = _Scan.apply(step, len(carry), len(xs), *carry, *xs, *consts)
        return tuple(out[:len(carry)]), tuple(out[len(carry):])
    return _loop(step, carry, xs, consts, _Trips(xs[0].shape[1]),
                 torch.einsum)[:2]
