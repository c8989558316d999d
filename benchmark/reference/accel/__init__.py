"""Part of the reference's frozen copy of the port's plain path."""
