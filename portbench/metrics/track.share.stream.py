"""Share of the traced video's chunk time in the tracker loops' spans:
``stream.track_features``, ``.track_chunk``, ``.seed``, ``.backtrack`` (%)."""

TRACKER = ("stream.track_features", "stream.track_chunk", "stream.seed", "stream.backtrack")


def read(ctx):
    spans = ctx["trace"]["span_wall_s"]
    if not any(n in spans for n in TRACKER):
        return None
    return 100.0 * sum(spans.get(n, 0.0) for n in TRACKER) / (sum(ctx["traced_chunks_ms"]) / 1e3)
