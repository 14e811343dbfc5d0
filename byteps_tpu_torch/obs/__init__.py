"""Observability of the port: the process-wide metrics registry, the
flight recorder of pipeline events and the PS exchange's stall
watchdog."""
