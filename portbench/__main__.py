"""``python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""

from portbench.run import main

raise SystemExit(main())
