"""K2: split-K flash-decode (see ``ops``)."""
