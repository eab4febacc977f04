"""Ocean cells of every threshold() + detect() pair completed in the
window, over the window: ``cells_per_s``'s reading, under the name of
the API cells' own metric."""

from benchmark.lib import spec

read = spec.module("metrics", "cells_per_s").read
