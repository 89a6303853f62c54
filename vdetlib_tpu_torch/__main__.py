"""``python -m vdetlib_tpu_torch <tool> [args...]`` — stage tool dispatcher
(the JAX package's 20 tools, ``vdetlib_tpu/cli/__init__.py``)."""

import importlib
import sys

TOOLS = {
    "calibrate": "vdetlib_tpu_torch.cli.calibrate",
    "detect": "vdetlib_tpu_torch.cli.detect",
    "eval_vid": "vdetlib_tpu_torch.cli.eval_vid",
    "frame_nms": "vdetlib_tpu_torch.cli.frame_nms",
    "gen_box_proto": "vdetlib_tpu_torch.cli.gen_box_proto",
    "gen_synth": "vdetlib_tpu_torch.cli.gen_synth",
    "gen_vid_proto": "vdetlib_tpu_torch.cli.gen_vid_proto",
    "import_vid": "vdetlib_tpu_torch.cli.import_vid",
    "mgp": "vdetlib_tpu_torch.cli.mgp",
    "pipeline": "vdetlib_tpu_torch.cli.pipeline_tool",
    "rescore": "vdetlib_tpu_torch.cli.rescore",
    "seq_nms": "vdetlib_tpu_torch.cli.seq_nms",
    "serve": "vdetlib_tpu_torch.cli.serve",
    "show_det": "vdetlib_tpu_torch.cli.show",
    "show_track": "vdetlib_tpu_torch.cli.show",
    "stream": "vdetlib_tpu_torch.cli.stream",
    "track": "vdetlib_tpu_torch.cli.track",
    "train_detector": "vdetlib_tpu_torch.cli.train_detector",
    "train_tracker": "vdetlib_tpu_torch.cli.train_tracker",
    "write_submission": "vdetlib_tpu_torch.cli.write_submission",
}


def dispatch(tool: str, argv: list[str]) -> int:
    """Run ``tool`` with ``argv``; the show tools also get their own name."""
    if tool not in TOOLS:
        raise SystemExit(f"unknown tool '{tool}'; available: {', '.join(sorted(TOOLS))}")
    mod = importlib.import_module(TOOLS[tool])
    rc = mod.main(argv, tool=tool) if tool.startswith("show_") else mod.main(argv)
    return rc or 0


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m vdetlib_tpu_torch <tool> [args...]")
        print("tools:", ", ".join(sorted(TOOLS)))
        return 0
    return dispatch(sys.argv[1], sys.argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
