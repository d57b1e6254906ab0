"""Static analysis of the port: the counterpart of ``src/repro/analysis``.

Four layers, each reading what the port really does (aten operations,
kernel launches, mesh messages, caches) where the reference reads
StableHLO, HLO and jit caches:

* :mod:`repro_torch.analysis.contracts`: declarative :class:`TraceContract`
  objects checked against one :class:`Traced` call of a named entry point
  (``launch/trace_analysis.py`` does the recording): M2L no-staging, the
  fused exchange's directions, the pipeline's issue depth, guard-free and
  sync-free steps, no write into ``rk2_step``'s inputs, no f64.
* :mod:`repro_torch.analysis.schedule`: the collective-schedule verifier,
  which runs a rank's host program for every rank id on a ``DryMesh`` and
  checks that all ranks issue the same collectives and that every send
  meets its receive (a mismatch is a distributed hang); it takes real
  ranks' logs as well.
* :mod:`repro_torch.analysis.retrace`: cache-miss accounting across a
  scripted session; an unexpected miss is named down to its cache and the
  argument that changed.
* :mod:`repro_torch.analysis.lint`: AST rules over the source tree.

``python -m repro_torch.analysis.check`` runs all four.
"""
from .contracts import (  # noqa: F401
    ContractResult, Traced, TraceContract, collective_count, evaluate,
    fewer_bytes, format_results, issue_depth_grows, launch_count,
    min_issue_depth, no_f64_upcast, no_host_callback, no_plain_calls,
    no_staging_dim, not_donated, sentinel_free, violations)
