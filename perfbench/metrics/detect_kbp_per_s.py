"""Kilobases of reference of the reads whose calls were drained in the
window, QC failures earning none, over the seconds from the window's
opening to its last drain (host clock).  Closing the count at the last
drain, not at the window's end, keeps the ordered drain's waves (a batch
and those queued behind it released at once) from moving the rate by
where the end falls between two waves."""


def read(run):
    return run.kbp / run.rate_s if run.rate_s > 0 else None
