"""Developer tools of the port (the metric-name lint)."""
