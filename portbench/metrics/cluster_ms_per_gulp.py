"""The host's clustering of a gulp's crossings into candidates
(SinglePulseSearch.host_seconds["cluster"]) over the window's gulps."""


def read(run):
    if not run.window_gulps:
        return None
    return 1e3 * run.search_parts["cluster"] / run.window_gulps
