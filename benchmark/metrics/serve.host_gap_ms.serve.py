"""ms per serving batch in which the program's `serve.query` span was open
and no device op ran: idle that ServeIndex.query's own host path causes
(the ids' copy in, launches, the results' copy out), apart from the
caller's time between queries."""
from benchmark import spans


def read(run):
    return spans.idle_ms_per_unit_within(run, "serve.query")
