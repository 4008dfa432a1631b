"""What one rank's eager step costs, counted op by op as it runs; the port's
counterpart of ``repro.roofline.hlo_costs``.

The reference walks the optimized HLO of a compiled program. The port has
no HLO: it runs eagerly, one aten op after another, so ``OpCounter`` (a
``TorchDispatchMode``) sees every op the step runs, on real tensors or on
fake ones (``torch._subclasses.fake_tensor.FakeTensorMode``, the dry run's
stand-ins, which allocate nothing):

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``, the op's share
  of its total. Like the reference's walk it counts the matmul family
  (mm, bmm, addmm, baddbmm, convolutions, attention) and no elementwise op.
  Its registry leaves out the products with a vector (mv, addmv, dot),
  which the reference's walk counts as dots: 2·|result|·|contraction| is
  added for those here.
- **Bytes**: each aten op's tensor operands and results, at their views'
  sizes. Eagerly every op is a launch that reads and writes device memory:
  the counterpart of the reference's "every instruction of a control
  computation". Ops that only make a view, allocate (``func.is_view``,
  ``empty``) or read metadata (no tensor result) move nothing. An in-place update of a slice counts the slice.
- **Interior bytes** (the reference's ``bytes_attn_interior``): the bytes
  of the ops that run inside a kernel's plain version, less that kernel's
  own operands and results. ``kernels._lib.plain`` tells the counter where
  each plain version begins and ends, so ``bytes − interior`` is what the
  step moves with the kernels in place.
- **Collective bytes**: what the step's collectives send, as the dry run's
  mesh stand-in reports them (``collective``): each all-reduce's operand
  bytes, by axes.
- **Peak live bytes**: the most bytes of op results alive at once (each
  result freed when its tensor is), the step's working set beside its
  arguments.

Every count is per device: the step of one rank. The per-op record keeps
(op, FLOPs, bytes, scope) with a count of the ops alike, so that a report
can be derived again from it (``OpCosts.to_json``, ``from_json``).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _lib

__all__ = ["OpCosts", "OpCounter", "tensor_bytes"]

_aten = torch.ops.aten
# ops that allocate without writing, or only reinterpret a tensor's bytes
_FREE = frozenset({
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default,
})


def _vector_product_flops(func, args) -> int:
    """2·|result|·|contraction| of a product with a vector, which
    FlopCounterMode's registry does not hold: mv and addmv (a matrix of
    m × n by n), dot and vdot (n by n)."""
    packet = func.overloadpacket
    if packet in (_aten.mv, _aten.addmv):
        m = args[1] if packet is _aten.addmv else args[0]
        return 2 * m.shape[0] * m.shape[1]
    if packet in (_aten.dot, _aten.vdot):
        return 2 * args[0].shape[0]
    return 0


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (nested lists, tuples and
    dicts), each at its own size."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class OpCosts:
    """One rank's counted step. ``ops`` counts (op, FLOPs, bytes, scope)
    alike, scope the kernel whose plain version ran the op (or ""),
    ``kernels`` (kernel, its own operand and result bytes), ``collectives``
    (op, axes, bytes)."""

    ops: Counter = dataclasses.field(default_factory=Counter)
    kernels: Counter = dataclasses.field(default_factory=Counter)
    collectives: Counter = dataclasses.field(default_factory=Counter)
    peak_live_bytes: int = 0
    seconds: float = 0.0

    @property
    def flops(self) -> float:
        return float(sum(f * n for (_, f, _, _), n in self.ops.items()))

    @property
    def bytes(self) -> float:
        return float(sum(b * n for (_, _, b, _), n in self.ops.items()))

    @property
    def interior_bytes(self) -> float:
        """The plain versions' op bytes past their kernels' own."""
        inside = sum(b * n for (_, _, b, scope), n in self.ops.items() if scope)
        own = sum(b * n for (_, b), n in self.kernels.items())
        return float(max(inside - own, 0))

    @property
    def collective_bytes(self) -> float:
        return float(sum(b * n for (_, _, b), n in self.collectives.items()))

    def collectives_by(self) -> dict[str, float]:
        """Collective bytes by ``op(axes)``."""
        out: dict[str, float] = {}
        for (op, axes, b), n in self.collectives.items():
            key = f"{op}({','.join(axes)})"
            out[key] = out.get(key, 0.0) + float(b * n)
        return out

    def to_json(self) -> dict:
        return {
            "ops": [[op, f, b, scope, n] for (op, f, b, scope), n in self.ops.items()],
            "kernels": [[k, b, n] for (k, b), n in self.kernels.items()],
            "collectives": [[op, list(axes), b, n] for (op, axes, b), n in self.collectives.items()],
            "peak_live_bytes": self.peak_live_bytes, "seconds": self.seconds,
        }

    @classmethod
    def from_json(cls, rec: dict) -> OpCosts:
        return cls(
            ops=Counter({(op, f, b, scope): n for op, f, b, scope, n in rec["ops"]}),
            kernels=Counter({(k, b): n for k, b, n in rec["kernels"]}),
            collectives=Counter({(op, tuple(axes), b): n for op, axes, b, n in rec["collectives"]}),
            peak_live_bytes=rec["peak_live_bytes"], seconds=rec["seconds"])


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter() as counter:`` into
    ``counter.costs``. Enter it inside a ``FakeTensorMode`` to count a step
    on stand-ins. One counter at a time listens to ``kernels._lib.plain``."""

    def __init__(self) -> None:
        super().__init__()
        self.costs = OpCosts()
        self._flops = FlopCounterMode(display=False)
        self._scopes: list[str] = []
        self._live = 0
        self._t0 = 0.0

    def __enter__(self):
        if _lib.plain_listener is not None:
            raise RuntimeError("an OpCounter is already counting")
        self._t0 = time.perf_counter()
        self._flops.__enter__()
        super().__enter__()
        _lib.plain_listener = self
        return self

    def __exit__(self, *exc):
        _lib.plain_listener = None
        super().__exit__(*exc)
        self._flops.__exit__(*exc)
        self.costs.seconds = time.perf_counter() - self._t0

    # --------------------------------------------------- the kernels' seam

    def enter_plain(self, kernel: str) -> None:
        self._scopes.append(kernel)

    def exit_plain(self, kernel: str) -> None:
        self._scopes.pop()

    def kernel_operands(self, kernel: str, args, out) -> None:
        """The kernel's own traffic: its operands read and results written once."""
        self.costs.kernels[(kernel, tensor_bytes(args) + tensor_bytes(out))] += 1

    # --------------------------------------------------------- collectives

    def collective(self, op: str, axes: tuple[str, ...], t: torch.Tensor) -> None:
        self.costs.collectives[(op, tuple(axes), t.numel() * t.element_size())] += 1

    # ------------------------------------------------------------- the ops

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self._flops.get_total_flops()
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE or not any(
                isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            return out  # a view, an allocation, or a query of metadata (prim.device)
        flops = self._flops.get_total_flops() - before + _vector_product_flops(func, args)
        nbytes = tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
        scope = self._scopes[-1] if self._scopes else ""
        self.costs.ops[(str(func), int(flops), nbytes, scope)] += 1
        if not func._schema.is_mutable:  # fresh results: the working set grows
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    size = t.numel() * t.element_size()
                    self._live += size
                    weakref.finalize(t, self._free, size)
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes, self._live)
        return out
