"""Deployment artifacts: serialize compiled build programs with jax.export.

Production serving wants the traced+lowered program as a versioned artifact:
ship the bytes, load them in a worker that never imports the model code, and
call — no retracing, no Python-side model closure, and (with
``platforms=("cpu", "cuda")``) one artifact that runs on the dev box and the
GPU server. This is the serving-side counterpart of the AOT dress rehearsal in
``tests/test_parallel.py`` (cross-platform lowering of the sharded build).

The reference has no deployment story (research scripts; SURVEY.md section
5); this module is beyond reference. Artifacts embed StableHLO, so they are
portable across processes and machines and stable across minor jax upgrades
(jax guarantees N-month backward compatibility for serialized exports).

Shapes are static — the loaded program serves exactly the traced shapes,
matching the framework's static-shape design (one compiled program per
shape family; see coresets/incremental.py). Export with the shapes you
serve; the traced-itrs entry points already make every build SIZE share one
program.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import jax
from jax import export as jax_export

_REGISTERED = False


def _register_framework_pytrees() -> None:
    """jax.export serializes pytree STRUCTURE by registered name: register
    the framework's state namedtuples once (idempotent)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from ..coresets.groups import GroupCoresetState
    from ..coresets.state import CoresetState
    from ..inference.laplace import LaplaceApprox

    for cls in (CoresetState, GroupCoresetState, LaplaceApprox):
        jax_export.register_namedtuple_serialization(
            cls, serialized_name=f"betacores_tpu.{cls.__name__}")
    _REGISTERED = True


def export_program(fn: Callable, *example_args,
                   platforms: Optional[Sequence[str]] = None) -> bytes:
    """Trace ``fn`` (jitted or plain) on ``example_args`` (concrete arrays or
    ``jax.ShapeDtypeStruct`` specimens — only shape/dtype are read) and
    return the serialized program bytes. ``platforms`` lowers for several
    backends in one artifact (e.g. ``("cpu", "cuda")``); default is the
    current backend."""
    _register_framework_pytrees()
    jfn = fn if isinstance(fn, jax.stages.Wrapped) else jax.jit(fn)
    exp = jax_export.export(jfn, platforms=platforms)(*example_args)
    return exp.serialize()


def load_program(data: bytes) -> Callable:
    """Deserialize bytes from :func:`export_program` into a callable that
    runs on the current default backend (which must be among the artifact's
    lowered platforms)."""
    _register_framework_pytrees()
    exp = jax_export.deserialize(data)
    return exp.call


def save_program(path: str, fn: Callable, *example_args,
                 platforms: Optional[Sequence[str]] = None) -> str:
    """``export_program`` to a file; returns ``path``."""
    data = export_program(fn, *example_args, platforms=platforms)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)  # atomic: a serving worker never reads a torn file
    return path


def load_program_file(path: str) -> Callable:
    with open(path, "rb") as fh:
        return load_program(fh.read())


def export_incremental_build(builder, data_spec, state, itrs_dtype=None,
                             platforms: Optional[Sequence[str]] = None,
                             data_weights_spec=None) -> bytes:
    """Serialize an incremental builder's full build program
    (``coresets/incremental.py``) as a deployment artifact.

    ``builder`` is a ``make_incremental_builder`` result; ``data_spec`` a
    concrete array or ``jax.ShapeDtypeStruct`` for the dataset operand (the
    dataset is a program ARGUMENT by design, so the artifact is
    dataset-independent at fixed shape); ``state`` a ``CoresetState``
    template (``init_state``). The exported signature is
    ``(data, key, state, itrs) -> state`` — or
    ``(data, data_weights, key, state, itrs) -> state`` when the builder was
    constructed with ``data_weights`` (the spec defaults to the builder's own
    weights, so the artifact NEVER silently drops them) or when
    ``data_weights_spec`` is given — with ``itrs`` a traced int32 operand,
    so one artifact serves every build size."""
    import jax.numpy as jnp

    if data_weights_spec is None:
        # a weighted builder must export the weighted program: exporting the
        # u=None branch would serve the UNWEIGHTED posterior (and could
        # select zero-weight rows the live builder provably excludes)
        data_weights_spec = getattr(builder, "data_weights", None)
    key = jax.random.key(0)
    itrs = jnp.zeros((), dtype=itrs_dtype or jnp.int32)
    if data_weights_spec is None:
        fn = lambda d, k, st, i: builder.build_with_data(d, None, k, st, i)
        return export_program(fn, data_spec, key, state, itrs,
                              platforms=platforms)
    fn = lambda d, u, k, st, i: builder.build_with_data(d, u, k, st, i)
    return export_program(fn, data_spec, data_weights_spec, key, state, itrs,
                          platforms=platforms)
