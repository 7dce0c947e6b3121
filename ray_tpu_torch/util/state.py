"""State API of the serve trace and metrics plane (the serve part of the
JAX package's ``util/state.py``: ``list_serve_requests`` and
``serve_trace``, ``ray_tpu/util/state.py:536-605``; ``metrics_address``
and ``query_metrics``, ``:121-137``, ``:275-282``).

Each reads the serve controller this process reaches: its own (the
process that called ``serve.run``), or the one whose address it inherited
(a replica). ``list_compiled_dags`` (``:45``) reads the driver's compiled
DAG rows (``dag/meter.py``). The rest of the JAX module reads its cluster
controller's tables (tasks, actors, nodes, logs), which the port does not
have.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def _req(method: str, **kwargs: Any) -> Any:
    from ..serve import controller

    return getattr(controller.controller_at(controller.current_address()),
                   method)(**kwargs)


def metrics_address() -> Optional[str]:
    """host:port of the serve controller's Prometheus ``/metrics``
    endpoint."""
    return _req("metrics_address")


def query_metrics(name: Optional[str] = None, *,
                  prefix: Optional[str] = None,
                  tags: Optional[Dict[str, str]] = None,
                  since: Optional[float] = None,
                  stat: Optional[str] = None,
                  window_s: float = 60.0,
                  limit_series: int = 64) -> Dict[str, Any]:
    """Metrics history from the sink's ring: filter by exact ``name`` or
    ``prefix`` and a tags subset; ``since`` is a wall-clock lower bound.
    Counters come back as per-second rates, histograms as derived series
    (``stat`` in p50/p99/mean/rate; default both quantiles). Returns
    {"enabled", "series": [{name, tags, type, stat, points: [[t, v],
    ...]}], "now", "step_s", "retain"}."""
    return _req("query_metrics", name=name, prefix=prefix, tags=tags,
                since=since, stat=stat, window_s=window_s,
                limit_series=limit_series)


def list_serve_requests(*, model: Optional[str] = None,
                        status: Optional[str] = None,
                        min_latency_s: Optional[float] = None,
                        since: Optional[float] = None,
                        limit: int = 100) -> List[Dict[str, Any]]:
    """Finished (and in-flight) serve requests from the request ledger
    (``serve/trace.py``), newest first. ``model`` filters by deployment
    name prefix; ``status`` by terminal status (ok / error / shed /
    deadline / cancelled / inflight); ``min_latency_s`` keeps only slower
    requests; ``since`` is a start_ts lower bound. Rows carry the
    terminal record and the token stats; one request's hop spans come
    with serve_trace()."""
    return _req("serve_requests", model=model, status=status,
                min_latency_s=min_latency_s, since=since, limit=limit)


def serve_trace(request_id: str) -> Dict[str, Any]:
    """One request's full trace: the ledger row plus its hop
    ``waterfall`` (:func:`waterfall`). ``request_id`` may be a unique
    prefix. Raises KeyError when the ledger has no such request."""
    rows = _req("serve_requests", request_id=request_id, limit=1)
    if not rows:
        raise KeyError(f"no serve request {request_id!r} in the ledger")
    row = dict(rows[0])
    row["waterfall"] = waterfall(row.get("spans") or ())
    return row


def waterfall(spans) -> List[Dict[str, Any]]:
    """Spans ordered depth-first with ``depth`` for indentation and
    ``self_s`` (the span's dwell minus its children's, clamped at zero),
    so the exclusive times sum to the root's dwell, the end-to-end
    wall."""
    spans = sorted(spans, key=lambda s: s.get("start_ts") or 0)
    by_id = {s.get("span_id"): s for s in spans}
    kids: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in spans:
        p = s.get("parent_span_id") or ""
        if p and p in by_id:
            kids.setdefault(p, []).append(s)
        else:
            roots.append(s)
    out: List[Dict[str, Any]] = []

    def walk(s: Dict[str, Any], depth: int) -> None:
        ch = kids.get(s.get("span_id"), ())
        dwell = float(s.get("dwell_s") or 0.0)
        child_sum = sum(float(c.get("dwell_s") or 0.0) for c in ch)
        out.append({
            "name": s.get("name"), "kind": s.get("kind"),
            "span_id": s.get("span_id"),
            "parent_span_id": s.get("parent_span_id") or "",
            "deployment": s.get("deployment") or "",
            "depth": depth, "start_ts": s.get("start_ts"),
            "dwell_s": dwell,
            "self_s": max(0.0, dwell - child_sum),
            "attributes": dict(s.get("attributes") or {}),
        })
        for c in ch:
            walk(c, depth + 1)

    for s in roots:
        walk(s, 0)
    return out


def list_compiled_dags() -> List[Dict[str, Any]]:
    """The live compiled DAGs of this driver: each one's stages, edges and
    depth, its recoveries (count, last cause, last seconds) and, once the
    meter has sampled twice, the stages' busy fractions (``stage_busy``),
    the edges' counters (``edge_stats``), steps a second and the
    ``bottleneck`` (``dag/meter.py``)."""
    from ..dag import meter

    meter.sample_now()
    return meter.rows()
