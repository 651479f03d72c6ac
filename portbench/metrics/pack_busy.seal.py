"""pack_busy.seal (%): the reader's copies of rows into fresh memory
(``batch._Bucket.flush`` packing rows of several volumes or a column
chunk, ``stripe._pad_to`` padding a volume's last small rows),
``PipeStats.pack_seconds`` over the seal call's ``wall_seconds``."""


def read(outcome):
    st = outcome.readings.get("pipe")
    pack = getattr(st, "pack_seconds", None)
    if not outcome.window.traced or pack is None or st.wall_seconds <= 0:
        return None
    return 100.0 * pack / st.wall_seconds
