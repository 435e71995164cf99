"""Programs that drive the port end to end (counterpart of the
repository's `examples/`): `northstar_demo`, BASELINE config 5."""
