"""Multi-device helpers of the port; so far the int8 gradient round trip
that the train step uses."""
