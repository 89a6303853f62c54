"""Share of the traced sweep's window inside ``fused.seq_nms`` (%)."""


def read(ctx):
    tr = ctx["trace"]
    if "fused.seq_nms" not in tr["span_wall_s"]:
        return None
    return 100.0 * tr["span_wall_s"]["fused.seq_nms"] / tr["window_s"]
