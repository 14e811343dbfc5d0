"""Launchers of the port: ``launch --server``, a standalone reduction
server process (``byteps_tpu/launcher/launch.py:76-165``)."""
