// Install view (reference: web-ui/src/views/Install): start the install
// task (env verify + model downloads), poll step progress, stream logs.

import { api, logStream } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast, toastError, attachLogPane } from "../ui.js";

const STEP_ICONS = {
  pending: "○",
  running: "◌",
  completed: "●",
  skipped: "◌",
  failed: "✕",
  cancelled: "✕",
};

let pollTimer = null;
// Poll chains can be parked in a timer OR awaiting installStatus; a timer
// clear can't cancel the latter, so each chain carries a generation and a
// stale chain drops its response instead of clobbering a newer task's state.
let pollGen = 0;

export function renderInstall(root, onLeave) {
  const s = wizard.state;
  root.append(
    el("h2", { class: "view-title" }, "Install"),
    el("p", { class: "view-sub" },
      "Verifies the runtime environment and downloads the model weights the config needs into the cache."),
    el("div", { class: "card" }, [
      el("div", { class: "checkrow" }, [
        el("input", { type: "checkbox", id: "inst-download", checked: "1" }),
        "download model weights for the saved config",
      ]),
      el("div", { class: "row" }, [
        el("button", { class: "btn primary", id: "inst-start" }, s.installDone ? "Re-run install" : "Start install"),
        el("button", { class: "btn danger", id: "inst-cancel", disabled: "1" }, "Cancel"),
        el("span", { class: "muted", id: "inst-status" }, s.installDone ? "install completed" : ""),
      ]),
      el("div", { class: "progress" }, el("div", { id: "inst-bar", style: "width:0%" })),
      el("ul", { class: "steplist", id: "inst-steps" }),
      el("p", { class: "muted", id: "inst-error" }),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Previous install tasks"),
      el("div", { class: "muted" },
        "Tasks from this control-plane session (reference SessionHub role): click one to resume watching it."),
      el("ul", { class: "steplist", id: "inst-history" }),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Live logs"),
      el("div", { class: "logpane", id: "inst-logs" }),
    ])
  );

  refreshHistory(root);

  const unsubLogs = attachLogPane(root.querySelector("#inst-logs"), logStream);
  onLeave(() => {
    unsubLogs();
    clearTimeout(pollTimer);
  });

  // resume a task in flight (reload mid-install)
  if (s.installTaskId && !s.installDone) poll(root, s.installTaskId, ++pollGen);

  root.querySelector("#inst-start").onclick = async () => {
    const btn = root.querySelector("#inst-start");
    btn.disabled = true;
    try {
      const download = root.querySelector("#inst-download").checked;
      if (download && !wizard.state.configPath) {
        // The server silently skips downloads without a config path; make
        // the operator save first instead of "completing" a no-op install.
        toast("save the config YAML first (Config step) so the install knows which models to download", true);
        btn.disabled = false;
        return;
      }
      if (wizard.state.cacheDir) {
        // Pre-flight the cache target (reference Install view checks the
        // path before starting): surface unwritable/low-disk up front
        // instead of failing minutes into the downloads.
        const check = await api.installCheckPath(wizard.state.cacheDir);
        if (!check.ok) {
          toast(`cache dir ${check.path} is not usable (writable=${check.writable}, free=${check.free_gb}GB)`, true);
          btn.disabled = false;
          return;
        }
        if (check.free_gb < 5) {
          toast(`cache dir has only ${check.free_gb}GB free — model downloads may fail`, true);
        }
      }
      const task = await api.installSetup({
        download,
        config_path: download ? wizard.state.configPath : null,
        cache_dir: wizard.state.cacheDir,
        region: wizard.state.region, // cn routes pip through a mirror
      });
      wizard.update({ installTaskId: task.task_id, installDone: false });
      root.querySelector("#inst-cancel").disabled = false;
      poll(root, task.task_id, ++pollGen);
    } catch (e) {
      toastError(e, "could not start the install");
      btn.disabled = false;
    }
  };

  root.querySelector("#inst-cancel").onclick = async () => {
    if (!wizard.state.installTaskId) return;
    try {
      await api.installCancel(wizard.state.installTaskId);
      toast("cancelling…");
    } catch (e) {
      toastError(e, "could not cancel the install");
    }
  };
}

async function refreshHistory(root) {
  let tasks;
  try {
    tasks = (await api.installTasks()).tasks || [];
  } catch {
    return; // history is best-effort; the live pane still works
  }
  if (!root.isConnected) return;
  const list = root.querySelector("#inst-history");
  if (!list) return;
  if (!tasks.length) {
    list.replaceChildren(el("li", { class: "muted" }, "none yet"));
    return;
  }
  list.replaceChildren(
    ...tasks
      .slice()
      .sort((a, b) => (b.created_at || 0) - (a.created_at || 0))
      .map((t) =>
        el("li", { class: t.status }, [
          el("span", { class: "step-ico" }, STEP_ICONS[t.status] || "○"),
          el(
            "a",
            {
              href: "#",
              onclick: async (ev) => {
                ev.preventDefault();
                // Never detach the UI (and the Cancel button) from the
                // install it is watching — guard FIRST, regardless of what
                // the (possibly stale) list snapshot claims about t.
                const current = wizard.state.installTaskId;
                if (current && !wizard.state.installDone && t.task_id !== current) {
                  toast("an install is in progress — finish or cancel it first", true);
                  return;
                }
                // Decide reattach-vs-inspect from a FRESH status, not the
                // mount-time snapshot (the task may have finished since).
                let fresh;
                try {
                  fresh = await api.installStatus(t.task_id);
                } catch (e) {
                  toastError(e, "could not load the task");
                  return;
                }
                if (!root.isConnected) return;
                if (fresh.status === "running" || fresh.status === "pending") {
                  wizard.update({ installTaskId: t.task_id, installDone: false });
                  poll(root, t.task_id, ++pollGen);
                } else {
                  // Terminal: read-only render, no state writes, no
                  // replayed completion/failure toasts.
                  renderTask(root, fresh);
                }
              },
            },
            t.task_id
          ),
          el("span", { class: "step-detail" }, `${t.status} · ${t.progress ?? 0}%`),
        ])
      )
  );
}

function renderTask(root, task) {
  // task.progress is already a 0-100 percentage (install.py progress).
  root.querySelector("#inst-bar").style.width = `${Math.round(task.progress || 0)}%`;
  const list = root.querySelector("#inst-steps");
  list.replaceChildren(
    ...task.steps.map((step) =>
      el("li", { class: step.status }, [
        el("span", { class: "step-ico" }, STEP_ICONS[step.status] || "○"),
        step.name,
        el("span", { class: "step-detail" }, step.detail || ""),
      ])
    )
  );
  root.querySelector("#inst-status").textContent = `status: ${task.status}`;
  root.querySelector("#inst-error").textContent = task.error || "";
}

async function poll(root, taskId, gen) {
  if (!root.isConnected || gen !== pollGen) return; // view switched / superseded
  clearTimeout(pollTimer); // a Start-triggered poll replaces a stale chain
  let task;
  try {
    task = await api.installStatus(taskId);
  } catch (e) {
    if (gen !== pollGen) return; // superseded while awaiting
    if (e.status === 404) {
      // Install tasks live in the control plane's memory; after a restart
      // a persisted id is gone for good — stop polling, forget it.
      wizard.update({ installTaskId: null });
      root.querySelector("#inst-status").textContent = "previous install task no longer exists";
      root.querySelector("#inst-start").disabled = false;
      root.querySelector("#inst-cancel").disabled = true;
      return;
    }
    // Transient control-plane hiccups must not freeze a running install's
    // progress display — keep polling.
    root.querySelector("#inst-status").textContent = `${e.message} (retrying…)`;
    pollTimer = setTimeout(() => poll(root, taskId, gen), 2000);
    return;
  }
  if (!root.isConnected || gen !== pollGen) return;

  renderTask(root, task);

  if (task.status === "running" || task.status === "pending") {
    root.querySelector("#inst-cancel").disabled = false;
    pollTimer = setTimeout(() => poll(root, taskId, gen), 900);
  } else {
    const startBtn = root.querySelector("#inst-start");
    startBtn.disabled = false;
    root.querySelector("#inst-cancel").disabled = true;
    if (task.status === "completed") {
      startBtn.textContent = "Re-run install";  // clear a stale Retry label
      wizard.update({ installDone: true });
      toast("install complete");
    } else if (task.status === "failed") {
      // Failure state with a one-click retry (reference Install view's
      // error affordance): the failed step is marked ✕ in the list above,
      // the task error is shown, and Start becomes Retry with the same
      // parameters.
      startBtn.textContent = "Retry install";
      const failedStep = (task.steps || []).find((s) => s.status === "failed");
      root.querySelector("#inst-error").textContent =
        (task.error ? `install failed: ${task.error}` : "install failed — see logs") +
        (failedStep ? ` (step: ${failedStep.name})` : "");
      toast(`install failed: ${task.error || "see logs"}`, true);
    } else if (task.status === "cancelled") {
      startBtn.textContent = "Re-run install";
      root.querySelector("#inst-status").textContent = "install cancelled";
    }
    refreshHistory(root); // terminal state: reflect it in the task list
  }
}
