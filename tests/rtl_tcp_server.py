"""Standalone protocol-exact rtl_tcp server (external test process).

Implements the rtl_tcp wire protocol of the rtl-sdr distribution: 12-byte
dongle header (magic "RTL0", tuner type u32, gain count u32, big-endian)
followed by a raw interleaved u8 IQ stream; 5-byte commands (u8 opcode +
u32 BE argument) accepted on the same socket.

Usage:
    python rtl_tcp_server.py PORTFILE [--bytes N] [--drop-after K]
                             [--accepts M] [--seed S]

Binds an ephemeral port on 127.0.0.1 and writes it to PORTFILE (so the
parent test can find it). Serves up to --accepts client connections; each
streams --bytes of deterministic pattern data. With --drop-after K the
server closes the connection after K bytes (simulating a dropout) and
goes back to accepting, letting clients exercise reconnect paths.
"""

import argparse
import socket
import struct
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("portfile")
    ap.add_argument("--bytes", type=int, default=1 << 20)
    ap.add_argument("--drop-after", type=int, default=0)
    ap.add_argument("--accepts", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    # Pace the stream at N bytes/second (0 = as fast as the socket
    # drains) and loop a bounded pattern buffer when --bytes exceeds
    # it — how a real dongle behaves (fixed sample rate, endless
    # stream).
    ap.add_argument("--rate", type=int, default=0)
    args = ap.parse_args()

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    with open(args.portfile, "w") as f:
        f.write(str(srv.getsockname()[1]))

    rng = np.random.default_rng(args.seed)
    pattern_len = min(args.bytes, 8 << 20)
    payload = rng.integers(0, 256, pattern_len, dtype=np.uint8).tobytes()

    for accept_i in range(args.accepts):
        try:
            conn, _ = srv.accept()
        except OSError:
            break
        # Small send buffer: backpressure keeps the stream position close
        # to what the client actually consumed, so --drop-after lands
        # mid-acquisition instead of disappearing into kernel buffers.
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 32768)
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        conn.settimeout(0.05)
        limit = args.drop_after if (args.drop_after
                                    and accept_i == 0) else args.bytes
        sent = 0
        t0 = time.monotonic()
        while sent < limit:
            try:
                data = conn.recv(5)
                while len(data) >= 5:
                    op, arg = struct.unpack(">BI", data[:5])
                    print(f"cmd {op:#x} {arg}", file=sys.stderr, flush=True)
                    data = data[5:]
            except socket.timeout:
                pass
            except OSError:
                break
            if args.rate:
                # Hold the cumulative stream position at the device
                # rate — ahead-of-schedule sends sleep the shortfall.
                ahead = sent - args.rate * (time.monotonic() - t0)
                if ahead > 0:
                    time.sleep(ahead / args.rate)
            try:
                pos = sent % len(payload)
                n = conn.send(payload[pos:pos + 8192])
                sent += n
            except socket.timeout:
                pass
            except OSError:
                break
        conn.close()
    srv.close()


if __name__ == "__main__":
    main()
