"""Master entrypoint: ``python -m dlrover_tpu_torch.master.main``.

Copy of ``dlrover_tpu/master/main.py``, the counterpart of DLRover's
``dlrover/python/master/main.py:112``.  The reference picks the local or
distributed master by platform; the port has the local master only, and
``--platform`` other than ``local`` and ``--enable_dashboard`` raise
``NotImplementedError`` (``ROADMAP_LAUNCHER_REST``).
"""

import os
import sys

from dlrover_tpu_torch.common.constants import ROADMAP_LAUNCHER_REST
from dlrover_tpu_torch.common.global_context import Context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.args import parse_master_args


def run(args) -> int:
    if args.platform != "local":
        raise NotImplementedError(
            f"--platform={args.platform}: the distributed master is not "
            f"ported yet ({ROADMAP_LAUNCHER_REST})")
    if args.enable_dashboard:
        raise NotImplementedError(
            "--enable_dashboard: the dashboard is not ported yet "
            f"({ROADMAP_LAUNCHER_REST})")
    ctx = Context.singleton_instance()
    ctx.master_service_type = args.service_type
    ctx.pre_check_enabled = bool(args.pre_check)
    os.environ.setdefault("DLROVER_TPU_NAMESPACE", args.namespace)
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    master = LocalJobMaster(
        port=args.port, node_num=args.node_num, job_name=args.job_name
    )
    master.hold = bool(getattr(args, "hold", False))
    master.prepare()
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(master.port))
    logger.info(
        "master started: job=%s platform=%s port=%d",
        args.job_name, args.platform, master.port,
    )
    return master.run()


def main(argv=None) -> int:
    args = parse_master_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
