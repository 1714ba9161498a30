"""Developer tools of the port: ``graftlint``, the invariant suite."""
