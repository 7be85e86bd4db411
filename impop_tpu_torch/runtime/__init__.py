"""Runtime pieces of the port: the result journal, stage timers, the
site-chunk stream of long windows and the similarity-window batcher."""
