import sys

from raymarchrenderer.app.cli import main

if __name__ == "__main__":
    # propagate verb exit codes (`parity` gates, render errors) — a bare
    # main() call swallows them and `python -m raymarchrenderer.app`
    # always exited 0
    sys.exit(main())
