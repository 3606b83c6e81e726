import sys

from repro_torch.audit.cli import main

sys.exit(main())
