"""NDS-H Throughput Run: N concurrent query streams.

Port of ``nds_tpu/nds_h/throughput.py`` on ``nds/throughput.py``'s
machinery: by default one plain subprocess of the port's NDS-H power CLI
(``python -m nds_tpu_torch.nds_h.power``) per stream, started together,
the throughput elapse max(end) - min(start) rounded up to 0.1 s. The
reference runs NDS-H streams only as subprocesses; the port adds
``--in_process``, NDS's one-card mode (one process, one Session, one
graph pool, the streams' statements interleaved), since every stream
process on one card holds a CUDA context and a graph pool of its own.

    python -m nds_tpu_torch.nds_h.throughput <warehouse> stream_1.sql \\
        stream_2.sql [--in_process] [--backend gpu|distributed|cpu] \\
        [--device cuda|cpu] [--out_dir DIR] [--output_prefix DIR]

Subprocess streams run supervised, as in ``nds/throughput.py``
(``--stall_s``, ``--max_restarts``, ``throughput_summary.json``).
"""

from __future__ import annotations

import argparse

from nds_tpu_torch.nds.throughput import (
    _stream_specs, add_throughput_args, run_cli, supervise,
)


def run_streams(data_dir: str, stream_paths: list[str], out_dir: str,
                backend: str = "gpu", input_format: str = "parquet",
                allow_failure: bool = False, device: "str | None" = None,
                output_prefix: "str | None" = None,
                stall_s: "float | None" = None,
                max_restarts: "int | None" = None
                ) -> tuple[float, list[int]]:
    """One supervised power-run subprocess per stream, started together;
    returns (throughput elapse in seconds, per-stream final exit
    codes)."""
    from nds_tpu_torch.nds_h.streams import parse_query_stream
    specs = _stream_specs(data_dir, stream_paths, out_dir, backend,
                          input_format, allow_failure,
                          "nds_tpu_torch.nds_h.power", parse_query_stream,
                          device, output_prefix)
    return supervise(specs, out_dir, stall_s, max_restarts)


def main(argv=None) -> None:
    from nds_tpu_torch.nds_h.power import SUITE
    p = argparse.ArgumentParser(description="NDS-H throughput run on the "
                                "port's engine")
    add_throughput_args(p, "engine.backend of every stream (default gpu: "
                        "the port's device engine)")
    args = p.parse_args(argv)
    run_cli(p, args, run_streams, SUITE)


if __name__ == "__main__":
    main()
