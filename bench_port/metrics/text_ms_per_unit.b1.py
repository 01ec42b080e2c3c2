"""Device milliseconds of a unit's text encode: the operations launched
inside the harness's spans around ``DiffusionEngine.text_embed`` (the
token-id uploads and both f32 CLIP towers; the engine encodes the null
prompt and the prompts apart, so two spans a unit), summed over the
profiled stretch, per unit."""


def read(rec):
    times = rec.trace.spans.get("text")
    return None if not times else 1e3 * sum(times) / rec.units
