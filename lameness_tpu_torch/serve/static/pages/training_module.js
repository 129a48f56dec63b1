// TrainingModule.tsx — the "Lameness Duolingo" learn surface, full flow:
// 4 views (training / progress / leaderboard / setup-admin), interactive
// quiz with binary + comparison modes, scoring/streak/levels persisted via
// PUT /api/training/learn/progress, hints, level-up banner, and the admin
// example-authoring table (create / edit / delete / auto-generate).
import {api, h, main, pct, esc, short, table, toast, USER}
  from "/static/app.js";

// TrainingModule.tsx TRAINING_LEVELS (level, name, minScore, difficulty)
const LEVELS = [
  [1, "Beginner", 0, "easy"], [2, "Apprentice", 3, "easy"],
  [3, "Practitioner", 8, "medium"], [4, "Expert", 13, "medium"],
  [5, "Master", 20, "hard"]];
// 7-point comparison scale (SCALE_LABELS)
const SCALE = [
  [-3, "A much more lame"], [-2, "A more lame"], [-1, "A slightly more lame"],
  [0, "Equal / cannot decide"],
  [1, "B slightly more lame"], [2, "B more lame"], [3, "B much more lame"]];
const TIERS = [["Gold", 0.85, "🥇"], ["Silver", 0.70, "🥈"],
               ["Bronze", 0, "🥉"]];

const levelOf = (score) =>
  LEVELS.filter(l => score >= l[2]).pop() || LEVELS[0];
const tierOf = (acc) => TIERS.find(t => (acc ?? 0) >= t[1]) || TIERS[2];

export default async function TrainingModule(view = "training") {
  const prog = await api("/api/training/learn/progress");
  const S = {                       // mutable quiz state, server-persisted
    score: prog.total_score || 0, streak: prog.streak || 0,
    attempts: prog.total_attempts || 0, correct: prog.correct_count || 0,
  };
  const persist = () => api("/api/training/learn/progress", {
    method: "PUT", json: {total_score: S.score, streak: S.streak,
                          total_attempts: S.attempts,
                          correct_count: S.correct}}).catch(() => {});
  const isAdmin = USER && USER.role === "admin";
  const views = ["training", "progress", "leaderboard",
                 ...(isAdmin ? ["setup"] : [])];

  main.append(h(`<div class="panel"><h2>Learn
      <span class="dim">score ${S.score} · 🔥 ${S.streak}</span></h2>
    <div class="row" id="tabs">${views.map(v =>
      `<button class="${v === view ? "action" : "ghost"}" data-v="${v}">
        ${v === "setup" ? "Setup (admin)" : v}</button>`).join("")}
    </div><div id="body" style="margin-top:10px"></div></div>`));
  document.querySelectorAll("#tabs button").forEach(b => {
    b.onclick = () => go("learn", b.dataset.v);
  });
  const body = document.getElementById("body");

  // ---------------------------------------------------------------- training
  if (view === "training") {
    const [tasks, ex] = await Promise.all([
      api("/api/tutorial/tasks").then(r => r.tasks).catch(() => []),
      api("/api/training/learn/examples").catch(() => ({examples: []}))]);
    const lvl = levelOf(S.score);
    const pairs = tasks.filter(t => t.is_active);
    const singles = ex.examples || [];
    let mode = pairs.length ? "comparison" : "binary";
    let qi = 0;

    body.append(h(`<div class="row" style="margin-bottom:8px">
      <span class="badge">Lv ${lvl[0]} ${esc(lvl[1])}</span>
      <span class="dim">accuracy ${S.attempts ?
        pct(S.correct / S.attempts) : "—"} (${S.correct}/${S.attempts})</span>
      <select id="mode">
        <option value="comparison">comparison (A vs B)</option>
        <option value="binary">binary (lame / sound)</option></select>
    </div><div id="quiz"></div><div id="fb"></div>`));
    const modeSel = document.getElementById("mode");
    modeSel.value = mode;
    modeSel.onchange = () => { mode = modeSel.value; qi = 0; ask(); };

    const quiz = document.getElementById("quiz");
    const fb = document.getElementById("fb");

    const grade = (ok, lvlAtAnswer) => {
      S.attempts += 1;
      if (ok) {
        S.correct += 1; S.streak += 1;
        // scoring = TrainingModule.tsx:533-535 (level*2 + streak bonus)
        const bonus = S.streak >= 3 ? Math.floor(S.streak / 3) : 0;
        S.score += lvlAtAnswer[0] * 2 + bonus;
        const next = LEVELS.find(l => l[2] > lvlAtAnswer[2]
                                 && S.score >= l[2]);
        fb.innerHTML = `<div class="panel ok">✓ correct! +${
          lvlAtAnswer[0] * 2 + bonus} points${
          S.streak >= 3 ? ` · 🔥 ${S.streak} streak (+${bonus})` : ""}${
          next ? `<div class="stat">LEVEL UP → ${esc(next[1])}!</div>` : ""}
          <button class="mini" id="nxt">next</button></div>`;
      } else {
        S.streak = 0; S.score += 1;   // consolation point (tsx:553)
        fb.innerHTML = `<div class="panel bad">✗ not quite (+1 for trying)
          <span id="why"></span>
          <button class="mini" id="nxt">next</button></div>`;
      }
      persist();
      document.getElementById("nxt").onclick = () => { qi += 1; ask(); };
      return fb.querySelector("#why");
    };

    function ask() {
      fb.innerHTML = "";
      if (mode === "comparison") {
        if (!pairs.length) {
          quiz.innerHTML = `<span class="dim">no comparison examples yet —
            ${isAdmin ? "create some in Setup, or auto-generate" :
              "ask an admin to create examples"}</span>`;
          return;
        }
        const t = pairs[qi % pairs.length];
        quiz.innerHTML = `<div class="vs">
          <div class="panel"><h3>Cow A</h3><video controls muted
            src="/api/videos/${t.video_id_1}/stream"
            style="max-height:170px"></video></div>
          <div class="panel"><h3>Cow B</h3><video controls muted
            src="/api/videos/${t.video_id_2}/stream"
            style="max-height:170px"></video></div></div>
          <div class="row" style="flex-wrap:wrap" id="scale">${
            SCALE.map(s => `<button class="ghost" data-s="${s[0]}"
              title="${esc(s[1])}">${s[0] > 0 ? "+" : ""}${s[0]}</button>`)
            .join("")}</div>
          <div class="row"><span class="badge">${esc(t.difficulty)}</span>
            ${t.hint ? `<button class="mini" id="hint">hint</button>
              <span id="hinttext" class="dim"></span>` : ""}</div>`;
        const hintBtn = quiz.querySelector("#hint");
        if (hintBtn) hintBtn.onclick = () => {
          quiz.querySelector("#hinttext").textContent = t.hint;
        };
        quiz.querySelectorAll("#scale button").forEach(b => {
          b.onclick = () => {
            const v = +b.dataset.s;
            // correct_winner 1=A, 2=B, 0=equal; degree 1-3
            const pick = v < 0 ? 1 : v > 0 ? 2 : 0;
            const ok = pick === t.correct_winner &&
              (pick === 0 || Math.abs(v) === (t.correct_degree || 2));
            const near = pick === t.correct_winner;   // right side, degree off
            const why = grade(ok || near, levelOf(S.score));
            if (why && !ok) {
              const lbl = t.correct_winner === 0 ? "equal" :
                `${t.correct_winner === 1 ? "A" : "B"} by ${t.correct_degree}`;
              why.textContent = ` — answer: ${lbl}.` +
                (t.description ? ` ${t.description}` : "");
            }
          };
        });
      } else {
        if (!singles.length) {
          quiz.innerHTML = `<span class="dim">no binary examples yet —
            analyze and label some videos first</span>`;
          return;
        }
        const e = singles[qi % singles.length];
        quiz.innerHTML = `<div class="panel" style="max-width:440px">
          <video controls muted src="/api/videos/${e.video_id}/stream"
            style="max-height:200px"></video>
          <div class="row" style="justify-content:center;margin-top:8px">
            <button class="ghost" data-l="lame">Lame</button>
            <button class="ghost" data-l="sound">Sound</button></div>
          <div class="dim">${esc(e.source)}</div></div>`;
        quiz.querySelectorAll("button[data-l]").forEach(b => {
          b.onclick = () => {
            const why = grade(b.dataset.l === e.label, levelOf(S.score));
            if (why) why.textContent = ` — it was ${e.label}` +
              (e.probability != null ? ` (p=${pct(e.probability)})` : "");
          };
        });
      }
    }
    ask();
  }

  // ---------------------------------------------------------------- progress
  if (view === "progress") {
    const lvl = levelOf(S.score);
    const acc = S.attempts ? S.correct / S.attempts : null;
    const tier = tierOf(prog.gold_accuracy ?? acc);
    body.append(h(`<div class="grid">
      <div class="panel"><div class="dim">score</div>
        <div class="stat">${S.score}</div></div>
      <div class="panel"><div class="dim">quiz accuracy</div>
        <div class="stat">${acc == null ? "—" : pct(acc)}</div>
        <div class="dim">${S.correct}/${S.attempts} correct</div></div>
      <div class="panel"><div class="dim">streak</div>
        <div class="stat">🔥 ${S.streak}</div></div>
      <div class="panel"><div class="dim">rater tier</div>
        <div class="stat">${tier[2]} ${tier[0]}</div>
        <div class="dim">gold accuracy ${prog.gold_accuracy == null ? "—"
          : pct(prog.gold_accuracy)}</div></div>
      <div class="panel"><div class="dim">real comparisons</div>
        <div class="stat">${prog.comparisons}</div>
        <div class="dim">rating tier ${esc(prog.tier)}</div></div>
    </div>
    <div class="panel"><h2>Levels</h2><div id="ladder"></div>
      <button class="mini" id="reset" style="margin-top:8px">
        reset quiz progress</button></div>`));
    document.getElementById("ladder").innerHTML = table(LEVELS, [
      ["", l => l[0] === lvl[0] ? "→" : ""],
      ["level", l => `Lv ${l[0]} <b>${esc(l[1])}</b>`],
      ["needs", l => `${l[2]} points`],
      ["difficulty", l => `<span class="badge">${esc(l[3])}</span>`],
      ["", l => S.score >= l[2] ? `<span class="ok">unlocked</span>`
        : `<span class="dim">locked</span>`]]);
    document.getElementById("reset").onclick = async () => {
      S.score = S.streak = S.attempts = S.correct = 0;
      await persist(); toast("progress reset"); go("learn", "progress");
    };
  }

  // -------------------------------------------------------------- leaderboard
  if (view === "leaderboard") {
    const board = (await api("/api/training/learn/leaderboard"))
      .leaderboard;
    body.innerHTML = table(board, [
      ["#", r => board.indexOf(r) + 1],
      ["rater", r => esc(r.username)],
      ["comparisons", r => r.n]]);
  }

  // -------------------------------------------------------------------- setup
  if (view === "setup" && isAdmin) {
    const [tasks, vids, stats] = await Promise.all([
      api("/api/tutorial/tasks").then(r => r.tasks),
      api("/api/videos?limit=200").then(r => r.videos),
      api("/api/tutorial/stats").catch(() => ({}))]);
    const opts = vids.map(v => `<option value="${v.id}">${
      esc(short(v.id, 10))} ${esc(v.original_filename || "")}</option>`)
      .join("");
    body.append(h(`<div class="row dim" style="margin-bottom:8px">
      ${stats.total_gold_tasks ?? tasks.length} gold tasks ·
      ${stats.tutorial_tasks ?? "?"} tutorial</div>
    <div class="panel"><h3>Create training example</h3>
      <div class="row"><select id="va">${opts}</select>
        <select id="vb">${opts}</select></div>
      <div class="row"><select id="cw"><option value="1">A more lame</option>
          <option value="2">B more lame</option>
          <option value="0">equal</option></select>
        <select id="cd"><option value="1">slightly (1)</option>
          <option value="2" selected>clearly (2)</option>
          <option value="3">much (3)</option></select>
        <select id="cdiff"><option>easy</option><option selected>medium</option>
          <option>hard</option></select></div>
      <div class="row"><input id="chint" placeholder="hint (optional)">
        <input id="cdesc" placeholder="explanation shown after answering">
      </div>
      <div class="row"><label><input type="checkbox" id="ctut" checked>
          tutorial example</label>
        <button class="action" id="create">Create</button>
        <button class="ghost" id="autogen">Auto-generate from Elo gaps</button>
      </div></div>
    <div class="panel"><h3>Existing examples</h3><div id="extable"></div></div>`));

    const renderTasks = (rows) => {
      document.getElementById("extable").innerHTML = rows.length
        ? table(rows, [
            ["A", t => short(t.video_id_1, 10)],
            ["B", t => short(t.video_id_2, 10)],
            ["answer", t => t.correct_winner === 0 ? "equal" :
              `${t.correct_winner === 1 ? "A" : "B"}+${t.correct_degree}`],
            ["difficulty", t => `<select data-id="${t.id}" class="ediff">
              ${["easy", "medium", "hard"].map(d => `<option ${
                d === t.difficulty ? "selected" : ""}>${d}</option>`).join("")}
              </select>`],
            ["hint", t => `<input class="ehint" data-id="${t.id}"
              value="${esc(t.hint || "")}" style="width:130px">`],
            ["tutorial", t => `<input type="checkbox" class="etut"
              data-id="${t.id}" ${t.is_tutorial ? "checked" : ""}>`],
            ["", t => `<button class="mini esave" data-id="${t.id}">save</button>
              <button class="mini edel" data-id="${t.id}">delete</button>`]])
        : `<span class="dim">no examples yet</span>`;
      document.querySelectorAll(".esave").forEach(b => {
        b.onclick = async () => {
          const id = b.dataset.id;
          const q = (c) => document.querySelector(`.${c}[data-id="${id}"]`);
          try {
            await api(`/api/tutorial/tasks/${id}`, {method: "PUT", json: {
              difficulty: q("ediff").value, hint: q("ehint").value,
              is_tutorial: q("etut").checked ? 1 : 0}});
            toast("saved");
          } catch (e) { toast(e.message, "bad"); }
        };
      });
      document.querySelectorAll(".edel").forEach(b => {
        b.onclick = async () => {
          try {
            await api(`/api/tutorial/tasks/${b.dataset.id}`,
                      {method: "DELETE"});
            toast("deleted"); go("learn", "setup");
          } catch (e) { toast(e.message, "bad"); }
        };
      });
    };
    renderTasks(tasks);

    document.getElementById("create").onclick = async () => {
      const g = (id) => document.getElementById(id).value;
      if (g("va") === g("vb")) return toast("pick two videos", "warn");
      try {
        await api("/api/tutorial/tasks", {json: {
          video_id_1: g("va"), video_id_2: g("vb"),
          correct_winner: +g("cw"), correct_degree: +g("cd"),
          difficulty: g("cdiff"), hint: g("chint"),
          description: g("cdesc"),
          is_tutorial: document.getElementById("ctut").checked}});
        toast("example created"); go("learn", "setup");
      } catch (e) { toast(e.message, "bad"); }
    };
    document.getElementById("autogen").onclick = async () => {
      try {
        const r = await api("/api/tutorial/auto-generate", {method: "POST"});
        toast(`generated ${r.created ?? ""} tasks`); go("learn", "setup");
      } catch (e) { toast(e.message, "bad"); }
    };
  }
}
