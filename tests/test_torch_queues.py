"""``serving.queues.OutputQueue.query`` when a result lands after the
client's socket timeout: the port's query blocks in slices shorter than
that timeout, so no timed-out read leaves its reply on the connection
(the reference's single long XREAD did: the next command read the late
XREAD reply, a nested list, and the front door answered 502 with
"'list' object has no attribute 'decode'")."""

import threading
import time

import numpy as np

from analytics_zoo_tpu_torch.serving.queues import (RESULT_PREFIX,
                                                    SIGNAL_PREFIX,
                                                    OutputQueue,
                                                    encode_ndarray)
from analytics_zoo_tpu_torch.serving.resp import RespClient, RespServer


def test_query_outlives_the_socket_timeout():
    srv = RespServer().start()
    try:
        q = OutputQueue("127.0.0.1", srv.port)
        q.client.sock.settimeout(0.4)
        want = np.arange(6, dtype=np.float32).reshape(2, 3)
        writer = RespClient("127.0.0.1", srv.port)

        def publish():
            time.sleep(1.0)
            writer.execute("HSET", RESULT_PREFIX + "u1", "value",
                           encode_ndarray(want))
            writer.execute("XADD", SIGNAL_PREFIX + "u1", "*", "ok", "1")

        t = threading.Thread(target=publish)
        t.start()
        got = q.query("u1", timeout=10.0)
        t.join(timeout=10)
        assert not t.is_alive()
        np.testing.assert_array_equal(got, want)
        # the connection is still in step: a later command reads its own
        # reply
        assert q.client.execute("HGETALL", RESULT_PREFIX + "u1") == []
    finally:
        srv.stop()
