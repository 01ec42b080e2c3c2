"""Host milliseconds a batch of the unprofiled stretch spends in the PNG
writer's calls inside the batch loop (queueing its eight writes), per batch.
The wait for the last batch's writes after the loop is not in it: the
run prints it apart."""


def read(rec):
    times = rec.host.get("png")
    return None if times is None else 1e3 * sum(times) / rec.units
