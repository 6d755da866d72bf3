"""Utilities: timing and tracing (``profiling``), plotting and animation
(``plotting``, matplotlib imported only when a plot is drawn)."""
