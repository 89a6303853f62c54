"""Share of the traced sweep's window inside ``runner.protos``: a video's
``FusedEngine._to_protos``, the read-back of the pipeline's outputs (which
waits for the card's queued work) and ``fused_to_protos`` (%)."""


def read(ctx):
    tr = ctx["trace"]
    if "runner.protos" not in tr["span_wall_s"]:
        return None
    return 100.0 * tr["span_wall_s"]["runner.protos"] / tr["window_s"]
