from raymarchrenderer.app.cli import main  # noqa: F401
