"""pipe_dispatch_busy.seal (%): the ingest plane's dispatch stage (the
calling thread handing batches to the codec: staging and the copies to
the card), ``PipeStats.dispatch_seconds`` over ``wall_seconds``."""


def read(outcome):
    st = outcome.readings.get("pipe")
    if st is None or st.wall_seconds <= 0:
        return None
    return 100.0 * st.dispatch_seconds / st.wall_seconds
