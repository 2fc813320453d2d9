"""Master CLI arguments.

Copy of ``dlrover_tpu/master/args.py`` (the counterpart of DLRover's
``master/args.py:145``): the same flags and defaults, so both packages
parse one argv alike; ``master/main.py`` refuses what the port lacks.
"""

import argparse

from dlrover_tpu_torch.common import envs

def parse_master_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="dlrover-tpu job master")
    parser.add_argument("--port", type=int, default=0,
                        help="service port; 0 picks a free port")
    parser.add_argument("--node_num", type=int, default=1,
                        help="number of worker hosts in the job")
    parser.add_argument("--job_name", type=str, default="tpu-job")
    parser.add_argument(
        "--platform", type=str, default="local",
        choices=["local", "k8s", "tpu_vm", "ray"],
    )
    parser.add_argument(
        "--service_type",
        type=str,
        default=envs.get_str("DLROVER_TPU_MASTER_SERVICE_TYPE"),
        choices=["grpc", "http"],
    )
    parser.add_argument("--namespace", type=str, default="default")
    parser.add_argument("--pre_check", type=int, default=1)
    parser.add_argument(
        "--relaunch_on_worker_failure", type=int, default=3,
        help="max relaunches per worker host",
    )
    parser.add_argument("--distribution_strategy", type=str, default="spmd")
    parser.add_argument("--port_file", type=str, default="",
                        help="write the bound port to this file on start")
    parser.add_argument("--enable_dashboard", action="store_true")
    parser.add_argument("--dashboard_port", type=int, default=0)
    parser.add_argument(
        "--hold", action="store_true",
        help="keep serving after the elastic workers finish (multi-role "
             "jobs: other roles still need the KV/sync fabric; the "
             "supervisor terminates the master at job teardown)",
    )
    return parser.parse_args(argv)
