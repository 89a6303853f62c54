"""Share of the traced sweep's window outside every ``fused.*`` span: the
runner's load waits, upload, ``fused_to_protos`` and proto writes (%)."""

FUSED = ("fused.detect", "fused.flow", "fused.nms_dedup", "fused.track_features",
         "fused.track_rounds", "fused.rescore", "fused.seq_nms")


def read(ctx):
    tr = ctx["trace"]
    inside = sum(tr["span_wall_s"].get(n, 0.0) for n in FUSED)
    return 100.0 * (tr["window_s"] - inside) / tr["window_s"]
