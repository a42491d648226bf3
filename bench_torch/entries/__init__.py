"""Entry points into the port, one module each, found by the ``entry`` a
traffic mix names.  Each has ``plan(ft, problem, dtype, flags, device)``,
``args(x)`` (the call's arguments made from a contiguous complex input),
``bind(ft, plan)`` (the callable the window drives), ``output(y)`` (the
call's result as one complex tensor, for the comparison) and ``wrap(f)``
(a complex-to-complex function in the entry's own form: how the control
stands in the program's place)."""
