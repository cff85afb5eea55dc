"""Distributed tracing: spans around task/actor submission and execution,
W3C trace context propagated inside the TaskSpec.

Parity: reference python/ray/util/tracing/tracing_helper.py:34-181
(_tracing_task_invocation wraps submission, _inject_tracing_into_function
wraps execution; context rides in the TaskSpec).

Two layers:
- Built-in propagation (always available): W3C `traceparent` strings are
  generated/parsed internally and carried in TaskSpec.trace_ctx, so a task
  anywhere in the cluster can see the root trace id.
- OpenTelemetry export (optional): when an OTel SDK TracerProvider is
  passed to `setup_tracing` (or installed globally), real spans are
  emitted through it as well — the standard API/SDK split: this library
  speaks the API, the application provides the SDK/exporter.

Enable with `setup_tracing()` in the driver; worker processes auto-enable
via the RAY_TPU_TORCH_TRACING env var.
"""

from __future__ import annotations

import contextvars
import os
import secrets
from contextlib import contextmanager

_enabled = False
_otel_tracer = None

# (trace_id_hex32, span_id_hex16) of the active span in this task/process.
_current: contextvars.ContextVar[tuple[str, str] | None] = \
    contextvars.ContextVar("ray_tpu_trace", default=None)


def setup_tracing(tracer_provider=None) -> None:
    """Turn on tracing in this process. Optionally pass a configured
    opentelemetry SDK TracerProvider to also export real spans."""
    global _enabled, _otel_tracer
    _enabled = True
    os.environ["RAY_TPU_TORCH_TRACING"] = "1"
    if tracer_provider is not None:
        from opentelemetry import trace

        trace.set_tracer_provider(tracer_provider)
        _otel_tracer = trace.get_tracer("ray_tpu_torch")
    else:
        try:
            from opentelemetry import trace

            _otel_tracer = trace.get_tracer("ray_tpu_torch")
        except ImportError:
            _otel_tracer = None


def maybe_setup_from_env() -> None:
    if not _enabled and os.environ.get("RAY_TPU_TORCH_TRACING") == "1":
        setup_tracing()


def enabled() -> bool:
    return _enabled


def _format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def _parse_traceparent(tp: str) -> tuple[str, str] | None:
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


def current_traceparent() -> str:
    """W3C traceparent for the active context ('' when none). Prefers a
    live OTel span (SDK installed), else the built-in context."""
    if not _enabled:
        return ""
    try:
        from opentelemetry import trace

        ctx = trace.get_current_span().get_span_context()
        if ctx.trace_id:
            return _format_traceparent(format(ctx.trace_id, "032x"),
                                       format(ctx.span_id, "016x"))
    except ImportError:
        pass
    cur = _current.get()
    if cur is None:
        return ""
    return _format_traceparent(*cur)


@contextmanager
def _span(name: str, task_id: str, parent_tp: str | None):
    """Built-in span: continue the parent's trace (or the ambient one, or
    start fresh), plus an OTel span when an SDK is wired up."""
    parent = _parse_traceparent(parent_tp) if parent_tp else None
    if parent is None:
        ambient = _parse_traceparent(current_traceparent() or "")
        parent = ambient
    trace_id = parent[0] if parent else secrets.token_hex(16)
    span_id = secrets.token_hex(8)
    token = _current.set((trace_id, span_id))
    otel_cm = None
    try:
        if _otel_tracer is not None:
            from opentelemetry import trace as otrace

            ctx = None
            if parent:
                from opentelemetry.trace import (
                    NonRecordingSpan,
                    SpanContext,
                    TraceFlags,
                )
                from opentelemetry.trace.propagation import set_span_in_context

                ctx = set_span_in_context(NonRecordingSpan(SpanContext(
                    trace_id=int(parent[0], 16), span_id=int(parent[1], 16),
                    is_remote=True, trace_flags=TraceFlags(1))))
            otel_cm = _otel_tracer.start_as_current_span(
                name, context=ctx, attributes={"ray_tpu_torch.task_id": task_id})
            otel_cm.__enter__()
        try:
            yield
        except BaseException:
            # Let the OTel span record the failure (status + exception
            # event) instead of exporting errored tasks as OK.
            if otel_cm is not None:
                import sys

                otel_cm.__exit__(*sys.exc_info())
                otel_cm = None
            raise
    finally:
        if otel_cm is not None:
            otel_cm.__exit__(None, None, None)
        _current.reset(token)


@contextmanager
def submit_span(name: str, task_id: str):
    """Span around client-side submission; yields the traceparent to embed
    in the TaskSpec (reference: _tracing_task_invocation)."""
    if not _enabled:
        yield ""
        return
    with _span(f"{name} ray_tpu_torch.remote", task_id, None):
        yield current_traceparent()


@contextmanager
def execute_span(name: str, task_id: str, traceparent: str):
    """Span around worker-side execution, parented to the submitter's span
    (reference: _inject_tracing_into_function). A spec carrying trace
    context activates tracing here even if this worker predates the
    driver's setup_tracing() (workers inherit env only at spawn time)."""
    if traceparent and not _enabled:
        maybe_setup_from_env()
        if not _enabled:
            setup_tracing()
    if not _enabled:
        yield
        return
    with _span(f"{name} ray_tpu_torch.execute", task_id, traceparent or None):
        yield
