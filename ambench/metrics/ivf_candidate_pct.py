"""Rows a lookup's probed sets hold, over the live rows: the mean over the
checked sample, from the reference's own partition."""


def read(record):
    rows = record["reference"].get("candidate_rows_mean")
    if rows is None:
        return None
    return 100.0 * rows / record["config"]["table"]["rows"]
