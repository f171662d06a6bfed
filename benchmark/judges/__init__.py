"""Judges of the bodies a traffic mix receives, one a file, named by the
mix (`judge.name`)."""
