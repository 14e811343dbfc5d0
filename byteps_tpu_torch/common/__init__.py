"""Runtime plumbing shared by the port: config, logging, bucketing."""
