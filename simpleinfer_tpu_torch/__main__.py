from .tools import main

raise SystemExit(main())
