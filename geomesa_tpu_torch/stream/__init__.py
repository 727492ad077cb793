"""The standing-query stream: a subscription matrix of Q standing queries and
the double-buffered scanner that streams host chunks through it.

Ports of :mod:`geomesa_tpu.stream.matrix` and the ``DeviceStreamScanner`` of
:mod:`geomesa_tpu.stream.pipeline`; the bus-fed hub, the journal and the
stream telemetry are not ported yet.
"""
