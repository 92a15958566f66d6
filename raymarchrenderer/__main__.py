"""`python -m raymarchrenderer` — the CLI entry point (app.cli)."""
from raymarchrenderer.app.cli import main

if __name__ == "__main__":
    main()
