"""The serving daemon's pieces (the JAX package's ``daemon/``).

Only :mod:`.qos`'s token bucket so far: the readahead budget of
:mod:`..autotune` shapes prefetch with it.  The daemon itself (server,
client, protocol, the QoS scheduler) is not part of this package yet."""
