"""Share of the traced sweep's window inside ``runner.write``: a video's
directory and its two ``proto_dump`` calls (%)."""


def read(ctx):
    tr = ctx["trace"]
    if "runner.write" not in tr["span_wall_s"]:
        return None
    return 100.0 * tr["span_wall_s"]["runner.write"] / tr["window_s"]
