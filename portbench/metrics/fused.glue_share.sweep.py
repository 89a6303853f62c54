"""Share of the traced sweep's window inside ``fused.pipeline`` and outside
its seven stage spans: the pipeline's own host work between the stages
(slot packing, the MGP hops, the output budget) (%)."""

FUSED = ("fused.detect", "fused.flow", "fused.nms_dedup", "fused.track_features",
         "fused.track_rounds", "fused.rescore", "fused.seq_nms")


def read(ctx):
    tr = ctx["trace"]
    spans = tr["span_wall_s"]
    if "fused.pipeline" not in spans:
        return None
    glue = spans["fused.pipeline"] - sum(spans.get(n, 0.0) for n in FUSED)
    return 100.0 * glue / tr["window_s"]
