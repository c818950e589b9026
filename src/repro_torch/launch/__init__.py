"""Launchers: the serving steps and batched greedy serving of the LM
substrate, and the operator CLI of the oversubscription budget
(`launch.oversubscribe`)."""
