"""Port of the matching ``snap_tpu`` subpackage."""
