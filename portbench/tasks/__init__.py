"""The questions of each task, frozen against the port's public
``DataFrame`` API, with their inputs, least bytes and answer readers;
one module a task, found by the ``task`` a mix file names."""
