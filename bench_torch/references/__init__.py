"""Plain references, one module per kind of transform, found by the name
a configuration gives: ``reference(x, axes, sign)`` in float64 and
``control(x, axes, sign)`` in the precision below the configuration's."""
