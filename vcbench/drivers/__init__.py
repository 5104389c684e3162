"""Drivers: one file a kind of entry the window drives, named by a traffic file."""
