"""Call patterns, one module each, found by the ``loop`` a traffic mix
names: ``run(fn, pool, seconds, keep, first, clock, span)`` calls ``fn``
on the argument tuples of ``pool`` in turn for ``seconds`` inside the
context ``span()``, hands each output to ``keep(index, output)``, and
returns the calls, failures, window seconds and the per-call series its
metrics read.  ``stream`` is the one pattern
the cells use."""
