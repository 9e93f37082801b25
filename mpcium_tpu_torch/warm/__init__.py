"""Warm-up before measured work. The port has no compile cache (its one
compiled kernel, K0, is built once per checkout by ``ops/mulmod.build``);
"warm" here means the bucket has run once in this process on its device."""
