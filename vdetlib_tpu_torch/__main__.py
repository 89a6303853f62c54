"""``python -m vdetlib_tpu_torch <tool> [args...]`` — stage tool dispatcher."""

import importlib
import sys

TOOLS = {
    "detect": "vdetlib_tpu_torch.cli.detect",
    "frame_nms": "vdetlib_tpu_torch.cli.frame_nms",
    "mgp": "vdetlib_tpu_torch.cli.mgp",
    "pipeline": "vdetlib_tpu_torch.cli.pipeline_tool",
    "rescore": "vdetlib_tpu_torch.cli.rescore",
    "seq_nms": "vdetlib_tpu_torch.cli.seq_nms",
    "stream": "vdetlib_tpu_torch.cli.stream",
    "track": "vdetlib_tpu_torch.cli.track",
    "train_detector": "vdetlib_tpu_torch.cli.train_detector",
    "train_tracker": "vdetlib_tpu_torch.cli.train_tracker",
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m vdetlib_tpu_torch <tool> [args...]")
        print("tools:", ", ".join(sorted(TOOLS)))
        return 0
    tool = sys.argv[1]
    if tool not in TOOLS:
        raise SystemExit(f"unknown tool '{tool}'; available: {', '.join(sorted(TOOLS))}")
    return importlib.import_module(TOOLS[tool]).main(sys.argv[2:]) or 0


if __name__ == "__main__":
    raise SystemExit(main())
