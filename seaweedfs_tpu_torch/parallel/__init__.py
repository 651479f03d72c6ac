"""Multi-device execution: the (dp, sp) split of EC work over local
devices, and the dry run that checks it."""
