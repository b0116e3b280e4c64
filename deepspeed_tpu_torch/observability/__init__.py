"""Observability for the serving column: spans (``trace``), the metrics
registry (``metrics``, ``schema``) and the profiler hook (``profiler``)."""
