from raymarchrenderer.diff.march import march_diff  # noqa: F401
