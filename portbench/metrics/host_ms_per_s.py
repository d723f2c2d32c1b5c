"""The station loop's own host work a data-second in the window: the
parts of StationPipeline.host_seconds (ring, staging, copy, drain) but
the wait for the card, and of SinglePulseSearch.host_seconds (dispatch,
decode, cluster) but the fetch, which waits for the card; the search's
total is the pipeline's `search` part, so that part is replaced by its
own parts."""

PIPE_WAITS = ("wait", "search")
SEARCH_WAITS = ("fetch",)


def read(run):
    if run.window_data_s == 0:
        return None
    own = sum(v for k, v in run.host_parts.items() if k not in PIPE_WAITS)
    own += sum(v for k, v in run.search_parts.items()
               if k not in SEARCH_WAITS)
    return 1e3 * own / run.window_data_s
