"""The drivers of the traffic mixes, named by a traffic file's
``driver``: ``execute(run)`` sets up, measures and checks one run."""
