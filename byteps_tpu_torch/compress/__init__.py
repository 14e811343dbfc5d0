"""The fused compression plane of the parameter-server path: the
self-describing wire codecs (``wire``), the pinned controller, the
worker-side plane with error feedback (``plane``) and the device encode
(``device``)."""
