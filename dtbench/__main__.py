"""`python3 -m dtbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`"""

import sys

from dtbench.run import main

sys.exit(main())
