"""Training on one device: AdamW and its schedules (``optimizer``), the
train step with microbatching (``loop``) and checkpoints in the
reference's on-disk format (``checkpoint``)."""
