"""Launchers: the train, eval and serving steps of the LM substrate,
training under the fault-tolerant loop (`launch.train`), batched greedy
serving (`launch.serve`), the operator CLI of the oversubscription budget
(`launch.oversubscribe`) and the monitor (`launch.monitor`)."""
