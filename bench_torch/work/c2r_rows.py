"""The work of the last-axis c2r pass of a real problem (K6's): r2c_rows
run backwards, the half spectrum read and the real rows written, so the
same bytes and flops."""
from .r2c_rows import work  # noqa: F401
