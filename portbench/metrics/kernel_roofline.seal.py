"""kernel_roofline.seal (%): the seal's GF(2^8) products at the card's
HBM peak, against the kernels' time in the device trace: the least
bytes of every product (yardstick.gf_call_bytes over the shapes handed
to the kernels) over the peak, divided by the summed kernel time."""

from portbench import yardstick


def read(outcome):
    r, reading = outcome.readings, outcome.window.reading
    if "dat_bytes" not in r or reading is None:
        return None
    return yardstick.roofline_percent(r["gf_bytes"], reading.gf_kernel_s,
                                      r["device_name"])
