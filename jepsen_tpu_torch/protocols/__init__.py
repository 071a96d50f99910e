"""Wire protocols the control host speaks directly to databases.

The reference's thicker suites talk real protocols from the control
node (rethinkdb's JSON protocol, disque/redis RESP, rabbitmq AMQP);
this package holds the Python-native implementations so registry
suites (suites/simple.py) can drive real daemons instead of generic
in-memory clients.
"""

from jepsen_tpu_torch.protocols.resp import (  # noqa: F401
    RespConnection,
    RespError,
    RespProtocolError,
)
