"""File codecs of the port: GUPPI RAW in, SIGPROC ``.fil`` out."""
