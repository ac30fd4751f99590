"""The op registry (the reference's kernel-registry analog,
``paddle_tpu/core/dispatch.py``). The reference's ``apply`` records each
op on its tape; here torch's autograd records every op already, so
``apply`` calls the op and notes its name."""
from __future__ import annotations

__all__ = ["apply", "OP_REGISTRY", "SEAM_OPS", "register_op",
           "populate_op_registry"]

# op name -> python callable
OP_REGISTRY: dict[str, object] = {}
# op names ``apply`` has run (names only)
SEAM_OPS: set[str] = set()


def register_op(name: str, fn):
    OP_REGISTRY[name] = fn
    return fn


def apply(fn, *args, op_name: str = "", **kwargs):
    """Run op ``fn(*args, **kwargs)``; torch's autograd records it."""
    if op_name:
        SEAM_OPS.add(op_name)
    return fn(*args, **kwargs)


def populate_op_registry():
    """Fill OP_REGISTRY with the port's public op surface: every public
    function of ``paddle_tpu_torch``, ``nn.functional`` under
    ``functional.<name>``, and ``linalg`` / ``incubate`` under
    ``<ns>.<name>``. Returns its size."""
    import inspect

    import paddle_tpu_torch as _p

    def take(ns, prefix=""):
        for name in dir(ns):
            if name.startswith("_"):
                continue
            fn = getattr(ns, name, None)
            if inspect.isfunction(fn) or inspect.isbuiltin(fn):
                OP_REGISTRY.setdefault(prefix + name, fn)

    take(_p)
    take(_p.nn.functional, "functional.")
    for ns_name in ("linalg", "incubate"):
        take(getattr(_p, ns_name), ns_name + ".")
    return len(OP_REGISTRY)
