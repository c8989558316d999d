"""The harness: cells found by name, the traffic generator, the traced
window, the check against the plain reference."""
