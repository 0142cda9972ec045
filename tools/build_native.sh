#!/bin/bash
# Build the native helper library (SA-IS suffix sorter, scalar SSW).
# Builds under a per-process name and renames into place, so concurrent
# builders never leave a partial library behind.
set -euo pipefail
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -o "libsaltnative.so.$$.tmp" sais.cpp ssw_native.cpp
mv -f "libsaltnative.so.$$.tmp" libsaltnative.so
echo "built $(pwd)/libsaltnative.so"
