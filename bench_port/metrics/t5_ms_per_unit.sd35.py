"""Device milliseconds of a unit's T5 encodes: the operations launched
inside the harness's spans around the T5 encoder's forward (the engine
encodes the null prompt and the prompt apart, so two spans a unit), summed
over the profiled stretch, per unit."""


def read(rec):
    times = rec.trace.spans.get("t5")
    return None if not times else 1e3 * sum(times) / rec.units
