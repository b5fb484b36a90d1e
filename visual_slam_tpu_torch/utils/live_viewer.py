"""Serve the interactive live 3D viewer over a LiveView dump directory
(port of visual_slam_tpu/utils/live_viewer.py).

The browser-based analog of the reference's Pangolin viewer process
(src/v2/viewer.py:9-257): this package's `utils/viewer.html` polls the
atomically written state.json / trajectory.json / map.ply that
utils.viz.LiveView maintains during a run, and renders map points,
trajectory and live stats with orbit controls.

Usage:
  python -m visual_slam_tpu_torch.pipeline --data DIR --frames 500 --live-dump LIVE &
  python -m visual_slam_tpu_torch.utils.live_viewer LIVE [port]
"""
from __future__ import annotations

import os
import shutil
import sys

VIEWER_HTML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "viewer.html")


def serve(dump_dir: str, port: int = 8642) -> None:
    """Copy viewer.html into `dump_dir` and serve it on 127.0.0.1:`port`."""
    import functools
    import http.server

    os.makedirs(dump_dir, exist_ok=True)
    shutil.copyfile(VIEWER_HTML, os.path.join(dump_dir, "viewer.html"))
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=dump_dir)
    with http.server.ThreadingHTTPServer(("127.0.0.1", port), handler) as httpd:
        print(f"live viewer: http://127.0.0.1:{port}/viewer.html")
        httpd.serve_forever()


if __name__ == "__main__":
    serve(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 8642)
