"""Model code of the port: layers, attention, the dense decoder, and the
``api`` entry points the serving engine calls."""
