"""pipe_read_busy.seal (%): the ingest plane's reader stage (packing the
volumes' rows into batches), ``PipeStats.read_seconds`` over the seal
call's ``wall_seconds``."""


def read(outcome):
    st = outcome.readings.get("pipe")
    if st is None or st.wall_seconds <= 0:
        return None
    return 100.0 * st.read_seconds / st.wall_seconds
