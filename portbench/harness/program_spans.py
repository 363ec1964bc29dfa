"""The program's own spans (`speinet_tpu_torch.utils.spans`), kept while
the profiled stretch ran, as the per-layer metrics that read them sum
them. A program without that module, or a run that kept none of the
spans asked for, gives None."""

from __future__ import annotations


def per_unit(names, per: str | None = None, device: bool = False):
    """Milliseconds in the spans named `names` (a name or a tuple of names;
    host clock, or with `device` the stream's time between each span's
    events), over the sum of `n` of the spans named `per` (default: the
    same spans). None where the sum has no span or the denominator is 0."""
    try:
        import speinet_tpu_torch.utils.spans as spans
    except ModuleNotFoundError:
        return None
    names = (names,) if isinstance(names, str) else tuple(names)
    kept = spans.recorded()
    timed = [s for s in kept if s.name in names
             and (s.device_ms is not None or not device)]
    count = sum(s.n for s in kept if s.name == per) if per else sum(s.n for s in timed)
    if not timed or not count:
        return None
    ms = sum(s.device_ms if device else (s.end - s.start) * 1e3 for s in timed)
    return ms / count
