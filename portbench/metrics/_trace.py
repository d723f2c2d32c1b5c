"""What the metric readers share of the profiled sub-window."""


def per_instance_ms(run, name: str):
    """Device ms of the operations launched under the host range `name`,
    per instance of the range; None without a trace or an instance."""
    t = run.trace
    if not t:
        return None
    seconds, n = t["by_range"].get(name, (0.0, 0))
    return 1e3 * seconds / n if n and seconds > 0 else None
