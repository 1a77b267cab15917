"""Multi-device / multi-host sharded decode."""
